"""Command-line tools, the counterparts of the reference's fa_* utilities:
port of blingfire_tpu/tools/cli.py.

  python -m blingfire_tpu_torch.tools.cli lex        --ldb M.bin  < text      # fa_lex
  python -m blingfire_tpu_torch.tools.cli ids        --ldb M.bin  < text      # test_ldb
  python -m blingfire_tpu_torch.tools.cli words      --ldb M.bin  < text
  python -m blingfire_tpu_torch.tools.cli sentences  --ldb M.bin  < text
  python -m blingfire_tpu_torch.tools.cli hyph       --ldb M.bin  < words     # w2h
  python -m blingfire_tpu_torch.tools.cli inspect    --ldb M.bin              # dump info
  python -m blingfire_tpu_torch.tools.cli build-dict --in pos.dict.utf8 --out M.bin ...
  python -m blingfire_tpu_torch.tools.cli build-lex  --in rules.lex --tagset t.txt --out M.bin
"""

from __future__ import annotations

import argparse
import sys


def _load(path):
    from ..api import load_model

    return load_model(path)


def cmd_words(args):
    tok = _load(args.ldb)
    for line in sys.stdin:
        print(tok.text_to_words(line.rstrip("\n")))


def cmd_sentences(args):
    tok = _load(args.ldb)
    for line in sys.stdin:
        print(tok.text_to_sentences(line.rstrip("\n")))


def cmd_ids(args):
    tok = _load(args.ldb)
    for line in sys.stdin:
        ids = tok.text_to_ids(line.rstrip("\n"), unk_id=args.unk)
        print(" ".join(map(str, ids)))


def cmd_lex(args):
    """Raw (Tag, From, To) triples, like fa_lex --out-pos."""
    from ..models.loader import load_model as lm
    from ..runtime.lexer import LexerEngine
    from ..runtime.oracle import utf8_to_utf32

    m = lm(args.ldb)
    eng = LexerEngine(m.wbd)
    for line in sys.stdin:
        dec = utf8_to_utf32(line.rstrip("\n").encode())
        if dec is None:
            print()
            continue
        cps = [0x20 if c == 0 else c for c in dec[0]]
        res = eng.process(cps)
        print(
            " ".join(
                f"{res[i]}:{res[i+1]}-{res[i+2]}" for i in range(0, len(res), 3)
            )
        )


def cmd_hyph(args):
    tok = _load(args.ldb)
    for line in sys.stdin:
        print(tok.word_hyphenation(line.rstrip("\n")))


def cmd_inspect(args):
    from ..models.loader import load_model as lm

    m = lm(args.ldb)
    print(f"dumps: {len(m.ldb.dump_offsets)}")
    for sec, mdl in (("wbd", m.wbd), ("pos-dict", m.seg), ("w2h", m.w2h)):
        if mdl is None:
            continue
        aut = mdl.aut
        print(
            f"[{sec}] states={aut.n_states} edges={len(aut.edge_src)} "
            f"finals={int(aut.final.sum())} max_iw={aut.max_iw}"
        )
    if m.seg is not None:
        print(
            f"[pos-dict] algo={m.seg.tok_algo.name} id_offset={m.seg.id_offset} "
            f"bytes={m.seg.use_raw_bytes} vocab={len(m.seg.i2info_ids)}"
        )
    if m.i2w is not None:
        print(f"[i2w] count={m.i2w.count} id_range=[{m.i2w.min_token_id},{m.i2w.max_token_id}]")


def cmd_build_dict(args):
    from ..compiler.dict import (
        DictModelSpec,
        compile_dict_model,
        vocab_from_pos_dict_lines,
    )
    from ..formats.consts import TokAlgo

    entries = vocab_from_pos_dict_lines(
        open(args.inp, encoding="utf-8"), input_enc=args.input_enc
    )
    spec = DictModelSpec(
        entries=entries,
        tok_algo=TokAlgo[args.tokalgo.upper().replace("-", "_")],
        id_offset=args.id_offset,
        use_byte_encoding=args.input_enc.lower() == "dec",
        no_dummy_prefix=args.no_dummy_prefix,
    )
    blob = compile_dict_model(spec)
    open(args.out, "wb").write(blob)
    print(f"wrote {args.out} ({len(blob)} bytes)")


def cmd_build_lex(args):
    from ..compiler.lexbin import compile_lex_model
    from ..compiler.lexrules import load_tagset, read_lex_source

    blob = compile_lex_model(
        read_lex_source(args.inp),
        load_tagset(args.tagset),
        dict_root=args.dict_root,
        max_depth=args.max_depth,
    )
    open(args.out, "wb").write(blob)
    print(f"wrote {args.out} ({len(blob)} bytes)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="blingfire_tpu_torch.tools.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (
        ("words", cmd_words),
        ("sentences", cmd_sentences),
        ("ids", cmd_ids),
        ("lex", cmd_lex),
        ("hyph", cmd_hyph),
        ("inspect", cmd_inspect),
    ):
        sp = sub.add_parser(name)
        sp.add_argument("--ldb", required=True)
        if name == "ids":
            sp.add_argument("--unk", type=int, default=0)
        sp.set_defaults(fn=fn)
    bd = sub.add_parser("build-dict")
    bd.add_argument("--in", dest="inp", required=True)
    bd.add_argument("--out", required=True)
    bd.add_argument("--input-enc", default="utf-8")
    bd.add_argument("--tokalgo", default="default")
    bd.add_argument("--id-offset", type=int, default=0)
    bd.add_argument("--no-dummy-prefix", action="store_true")
    bd.set_defaults(fn=cmd_build_dict)
    bl = sub.add_parser("build-lex")
    bl.add_argument("--in", dest="inp", required=True)
    bl.add_argument("--tagset", required=True)
    bl.add_argument("--out", required=True)
    bl.add_argument("--dict-root", default=".")
    bl.add_argument("--max-depth", type=int, default=4)
    bl.set_defaults(fn=cmd_build_lex)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
