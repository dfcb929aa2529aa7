# Copy of blingfire_tpu/compiler/wordpiece.py, kept here so that this package imports nothing of the JAX package.
"""WordPiece model builder: HF-style vocab.txt -> complete [wbd] .bin.

Equivalent of ldbsrc/*/vocab_to_fa_lex.py + fa_build_lex: generates the
longest-match subword rules from the vocabulary, merges them into the BERT
word-breaking grammar as the FnTokWord body, and compiles everything to a
loadable model."""

from __future__ import annotations

from .lexbin import compile_lex_model
from .lexrules import load_tagset

_ESC = {"\\": "[\\x5C]", "]": "[\\]]", "[": "[\\[]", "^": "[\\x5E]", "-": "[\\-]"}


def vocab_to_falex(vocab_lines: list[str], id_base: int = 100):
    """Returns (falex_text, tagset_extra) — reference semantics
    (ldbsrc/bert_base_cased_tok/vocab_to_fa_lex.py): ids < id_base are
    special tokens handled by explicit grammar rules."""
    rules = []
    tags = {}
    for tid, line in enumerate(vocab_lines):
        if tid < id_base:
            continue
        line = line.strip()
        is_internal = len(line) >= 2 and line[:2] == "##"
        tok = line[2:] if is_internal else line
        anchor = "" if is_internal else "^ "
        reg = "".join(_ESC.get(c, "[" + c + "]") for c in tok)
        if not reg:
            continue
        rules.append(f" < {anchor}{reg} > --> WORD_ID_{tid}")
        tags[f"WORD_ID_{tid}"] = tid
    return "\n".join(rules), tags


def compile_wordpiece_model(
    vocab_lines: list[str],
    grammar_text: str,
    tagset: dict[str, int],
    dict_root: str = ".",
    id_base: int = 100,
    charmap: dict[int, list[int]] | None = None,
    max_depth: int = 4,
) -> bytes:
    """Compile a WordPiece model from a vocab + word-breaking grammar.

    `grammar_text` must reference the function `FnTokWord`; its body is
    replaced with the generated vocabulary rules (the reference grammars use
    `_include <model>/vocab.falex` for this)."""
    falex, extra_tags = vocab_to_falex(vocab_lines, id_base)
    ts = dict(tagset)
    ts.update(extra_tags)
    # inject the vocab body at the _include site or an empty FnTokWord
    if "_include" in grammar_text and "vocab.falex" in grammar_text:
        out_lines = []
        for ln in grammar_text.splitlines():
            if ln.strip().startswith("_include") and "vocab.falex" in ln:
                out_lines.append(falex)
            else:
                out_lines.append(ln)
        grammar_text = "\n".join(out_lines)
    else:
        grammar_text = grammar_text + "\n_function FnTokWord\n" + falex + "\n_end\n"
    return compile_lex_model(
        grammar_text,
        ts,
        dict_root=dict_root,
        max_depth=max_depth,
        charmap=charmap,
    )
