"""The port's host-only modules against the JAX package's on the CPU:
compiler/morphbin.py (the same image bytes), runtime/morph.py (every engine
of a morphology model and the regexp tagger on seeded words),
runtime/transforms.py, compiler/fsmio.py (print and read), and the command
line (python -m blingfire_tpu_torch.tools.cli against python -m
blingfire_tpu.tools.cli, every subcommand).  Tolerance 0 throughout."""

from __future__ import annotations

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from blingfire_tpu.compiler import fsmio as jax_fsmio
from blingfire_tpu.compiler import morphbin as jax_mb
from blingfire_tpu.formats import consts as jax_consts
from blingfire_tpu.runtime import morph as jax_morph
from blingfire_tpu.runtime import transforms as jax_tr
from blingfire_tpu_torch import MorphLdb, load_morph, load_regexp_tags
from blingfire_tpu_torch import testing
from blingfire_tpu_torch.compiler import fsmio
from blingfire_tpu_torch.compiler import morphbin as mb
from blingfire_tpu_torch.formats import consts
from blingfire_tpu_torch.runtime import morph
from blingfire_tpu_torch.runtime import transforms as tr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = lambda s: [ord(c) for c in s]  # noqa: E731
TAGS = {"NN": 1, "VB": 2, "JJ": 3, "DT": 4, "EOS": 5}
WORDS = [
    "walking", "talking", "working", "dog", "dogs", "the", "cities",
    "walked", "zzz", "a", "run", "runs", "ing", "s", "x", "walk",
    "puppies", "strings", "", "Walking", "éte",
]


def _seeded_words(n: int = 40) -> list[str]:
    rng = random.Random(5)
    return ["".join(rng.choice("adeginklorstwy") for _ in range(rng.randint(1, 9)))
            for _ in range(n)]


def morph_spec(m, c):
    """A model with every engine (the fixture of tests/test_morph.py),
    built from the morphbin module ``m`` and the consts module ``c`` of
    one package."""
    return m.MorphSpec(
        w2t=m.WgSpec({"walking": [2], "talking": [2, 3], "ing": [2],
                      "ed": [2], "dog": [1], "the": [4], "s": [1, 2]},
                     direction=c.Dir.R2L, def_tag=TAGS["NN"]),
        b2t=m.WgSpec({"walk": [2], "dog": [1]}, dict_mode=True,
                     add_delim=False),
        w2tp=m.WgSpec({"walking": [2, 240], "dog": [1, 2, 230, 40],
                       "the": [4, 255], "ing": [2, 1, 200, 55],
                       "s": [1, 2, 128, 127], "e": [1, 99]},
                      direction=c.Dir.R2L, def_tag=TAGS["NN"], max_prob=255,
                      log_scale=True, prob_range=(-15.0, 0.0),
                      eos_tag=TAGS["EOS"]),
        t2p=[-1.2, -2.3, -3.4, -0.5, -4.0],
        tt2p=m.TsSpec(max_tag=5,
                      int_probs=[(i * 37 + j * 11) % 256 for i in range(5)
                                 for j in range(5)],
                      max_prob=255, prob_range=(-12.0, 0.0), log_scale=True),
        w2b=m.WftSpec([m.SuffixRule("ing", 3, ""), m.SuffixRule("ies", 3, "y"),
                       m.SuffixRule("s", 1, "")]),
        b2w=m.WftSpec([m.SuffixRule("walk", 0, "ing", whole_word=True),
                       m.SuffixRule("y", 1, "ies"), m.SuffixRule("g", 0, "s")]),
        wt2b=m.WftSpec([m.SuffixRule("ing", 3, "", tags=(2,)),
                        m.SuffixRule("s", 1, "", tags=(1, 2))]),
        b2wt=m.WftSpec([m.SuffixRule("k", 0, "ing", tags=(2,)),
                        m.SuffixRule("g", 0, "s", tags=(1,))]),
        tag_dict=m.TagDictSpec(entries={"run": [1, 2, 7], "runs": [2],
                                        "dog": [1, 5], "a": [4]}),
        w2p=m.W2PSpec(entries={"the": 255, "dog": 200, "walking": 100,
                               "a": 30},
                      max_prob=255, prob_range=(-20.0, 0.0)),
    )


def wre_spec(m, c):
    base = 100
    return m.MorphSpec(
        wre=m.WreSpec(token_type=c.WRE_TT_TAGS, tag_ow_base=base, rules=[
            m.WreRule(tuples=[(base + 4,), (base + 1,)], action=[0, 0, 10]),
            m.WreRule(tuples=[(base + 10,), (base + 2,)], action=[0, 0, 11]),
        ], max_pass_count=2),
        trs=m.TrsSpec(in_trs=[c.Tr.HYPH_REDUP], redup_delim=ord("~")),
        validate=True)


def regexp_rules(m):
    return [m.RegexpTagsRule(regexp="[0-9]+", score=10, tag=1),
            m.RegexpTagsRule(regexp="[a-z]+", score=5, tag=2),
            m.RegexpTagsRule(regexp="^http", score=20, tag=3),
            m.RegexpTagsRule(regexp="[.][a-z][a-z][a-z]$", score=15, tag=4)]


@pytest.fixture(scope="module")
def morph_pair(tmp_path_factory):
    """The model loaded from a file by each package's load_morph."""
    path = tmp_path_factory.mktemp("morph") / "morph.bin"
    path.write_bytes(mb.compile_morph_model(morph_spec(mb, consts)))
    ours, theirs = load_morph(str(path)), jax_morph.load_morph(str(path))
    assert isinstance(ours, MorphLdb)
    return ours, theirs


@pytest.mark.parametrize("build", ["morph", "wre", "regexp_tags"])
def test_compilers_give_the_same_bytes(build):
    if build == "morph":
        got = mb.compile_morph_model(morph_spec(mb, consts))
        want = jax_mb.compile_morph_model(morph_spec(jax_mb, jax_consts))
    elif build == "wre":
        got = mb.compile_morph_model(wre_spec(mb, consts))
        want = jax_mb.compile_morph_model(wre_spec(jax_mb, jax_consts))
    else:
        got = mb.compile_regexp_tags_model(regexp_rules(mb))
        want = jax_mb.compile_regexp_tags_model(regexp_rules(jax_mb))
    assert isinstance(got, bytes) and len(got) > 64 and got == want


def test_word_guessers(morph_pair):
    ours, theirs = morph_pair
    for name in ("w2t", "b2t"):
        g, jg = ours.word_guesser(name), theirs.word_guesser(name)
        assert g is not None
        for w in WORDS + _seeded_words():
            assert g.process(W(w)) == jg.process(W(w)), (name, w)
    g, jg = ours.word_guesser_prob("w2tp"), theirs.word_guesser_prob("w2tp")
    for w in WORDS + _seeded_words():
        got, want = g.process_probs(W(w)), jg.process_probs(W(w))
        if got is None or want is None:
            assert got is None and want is None, w
            continue
        assert list(got[0]) == list(want[0]), w
        np.testing.assert_array_equal(np.asarray(got[1], np.float32),
                                      np.asarray(want[1], np.float32), w)


def test_tag_dict_prob_tables_and_hmm(morph_pair):
    ours, theirs = morph_pair
    d, jd = ours.dict_interpreter(), theirs.dict_interpreter()
    for w in WORDS + _seeded_words():
        assert d.get_info_id(W(w)) == jd.get_info_id(W(w)), w
        assert d.get_info(W(w)) == jd.get_info(W(w)), w
    pt, jpt = morph.T2PTable(ours.t2p), jax_morph.T2PTable(theirs.t2p)
    ptt, jptt = morph.Ts2PTable(ours.tt2p), jax_morph.Ts2PTable(theirs.tt2p)
    for t in range(1, 6):
        assert np.float32(pt.get_prob(t)) == np.float32(jpt.get_prob(t))
        for t2 in range(1, 6):
            assert (np.float32(ptt.get_prob2(t, t2))
                    == np.float32(jptt.get_prob2(t, t2))), (t, t2)
    tagger, jtagger = ours.hmm_tagger(), theirs.hmm_tagger()
    assert tagger is not None
    rng = random.Random(9)
    sents = [["the", "dog", "walking"], ["dog"],
             ["the", "dog", "s", "ing", "e"],
             ["zzz", "the", "walking", "dog", "e", "s"]]
    sents += [rng.sample(WORDS[:18], rng.randint(1, 8)) for _ in range(20)]
    for sent in sents:
        assert (tagger.tag([W(w) for w in sent])
                == jtagger.tag([W(w) for w in sent])), sent


def test_stemmer_and_word_to_prob(morph_pair):
    ours, theirs = morph_pair
    st, jst = ours.stemmer(), theirs.stemmer()
    w2p, jw2p = ours.word_to_prob(), theirs.word_to_prob()
    for w in WORDS + _seeded_words():
        x = W(w)
        assert st.process_w2b(x) == jst.process_w2b(x), w
        assert st.process_b2w(x) == jst.process_b2w(x), w
        assert st.process_w2w(x) == jst.process_w2w(x), w
        for t in (1, 2, 3):
            assert st.process_wt2b(x, t) == jst.process_wt2b(x, t), (w, t)
            assert st.process_b2wt(x, t) == jst.process_b2wt(x, t), (w, t)
        assert st.process_wtt2w(x, 2, 1) == jst.process_wtt2w(x, 2, 1), w
        assert w2p.get_int_prob(x) == jw2p.get_int_prob(x), w
        assert np.float32(w2p.get_prob(x)) == np.float32(jw2p.get_prob(x)), w


def test_wre_parser_and_input_transforms():
    image = mb.compile_morph_model(wre_spec(mb, consts))
    ours, theirs = MorphLdb(image), jax_morph.MorphLdb(image)
    cases = [(["the", "dog", "walks"], [4, 1, 2]), (["the", "dog"], [4, 1]),
             (["dog", "walks"], [1, 2]),
             (["the", "dog", "walks", "the", "dog"], [4, 1, 2, 4, 1]),
             (["dog", "the", "dog", "walks", "walks"], [1, 4, 1, 2, 2])]
    for words, tags in cases:
        got = []
        for ldb, pkg in ((ours, morph), (theirs, jax_morph)):
            wre = ldb.wre_parser()
            assert wre is not None
            wre.reset(len(words))
            for w, t in zip(words, tags):
                wre.add_word(W(w), t)
            tree = pkg.ParseTree(len(words))
            wre.set_parse_tree(tree)
            added = wre.process()
            tree.update()
            got.append((added, tree.get_upper_labels()))
        assert got[0] == got[1], (words, tags)


def test_regexp_tagger():
    image = mb.compile_regexp_tags_model(regexp_rules(mb))
    ours, theirs = load_regexp_tags(image), jax_morph.load_regexp_tags(image)
    for s in ["http://x.com", "hello", "42", "abc123", "x.txt", "HTTP", "",
              "tail.doc", "99 bottles"] + _seeded_words():
        assert ours.process(W(s)) == theirs.process(W(s)), s


TR_CASES = ["aaab-aaabce", "ab-abx", "x-yz", "nothing", "pre~word",
            "word~pre", "Capital", "lower", "A", "ab\\tcd", "a\\nb", "bad\\q",
            "plain\tTAB", "", "ÉCOLE", "éte-éte"]


@pytest.mark.parametrize("name", ["HyphRedup", "HyphRedupRev", "PrefixRev",
                                  "Capital", "CapitalRev", "Unescape",
                                  "Prefix", "Cascade"])
def test_transforms(name):
    delim = ord("~")

    def make(mod, pkg_morph, mbm):
        if name == "Unescape":
            return mod.Unescape()
        if name in ("Prefix", "Cascade"):
            n, final, edges, state_ow = mbm.build_trie_moore(
                {tuple(W(p)): 0 for p in ("pre", "un", "anti")})
            img = mbm._pack_moore(n, final, edges, state_ow)
            from importlib import import_module
            dfa = import_module(pkg_morph.__name__.rsplit(".", 2)[0]
                                + ".formats.dfa")
            walker = pkg_morph.DfaWalker(
                dfa.densify_automaton(dfa.PackedDfaImage(img, 0)))
            pre = mod.Prefix(walker, delim)
            if name == "Prefix":
                return pre
            return mod.Cascade([mod.Capital(delim), pre,
                                mod.HyphRedup(delim)])
        return getattr(mod, name)(delim)

    ours = make(tr, morph, mb)
    theirs = make(jax_tr, jax_morph, jax_mb)
    for s in TR_CASES + ["preword", "unknown", "antique", "pre", "un", "u",
                         "Preword"] + _seeded_words():
        assert ours(W(s)) == theirs(W(s)), (name, s)


def _rand_dfa(pkg, seed: int, n: int = 25, n_iw: int = 8):
    rng = random.Random(seed)
    trans = {}
    for s in range(n):
        for iw in range(n_iw):
            if rng.random() < 0.35:
                trans[(s, iw)] = rng.randrange(n)
    finals = sorted(rng.sample(range(n), 4))
    d = pkg.TextDfa(n - 1, n_iw - 1, 0, finals, trans)
    d.arc_ow = {k: rng.randrange(100) for k in trans if rng.random() < 0.5}
    d.state_ow = {s: rng.randrange(50) for s in finals}
    d.state_ows = {s: sorted(rng.sample(range(60), rng.randrange(1, 4)))
                   for s in finals}
    return d


def _fields(d) -> dict:
    return {k: v for k, v in vars(d).items()}


@pytest.mark.parametrize("mode", ["rs", "mealy", "moore", "moore-mult"])
def test_fsmio_dfa_print_and_read(mode):
    for seed in (1, 2, 3):
        text = fsmio.print_dfa(_rand_dfa(fsmio, seed), mode)
        assert text == jax_fsmio.print_dfa(_rand_dfa(jax_fsmio, seed), mode)
        assert _fields(fsmio.read_dfa(text, mode)) == _fields(
            jax_fsmio.read_dfa(text, mode))
        back = fsmio.read_dfa(text, mode)
        assert fsmio.print_dfa(back, mode) == text


def test_fsmio_nfa_maps_and_builders():
    rng = random.Random(7)
    trans = {}
    for s in range(12):
        for iw in range(5):
            if rng.random() < 0.4:
                trans[(s, iw)] = sorted(rng.sample(range(12), rng.randrange(1, 3)))
    for mealy in (False, True):
        text = fsmio.print_nfa(fsmio.TextNfa(11, 4, [0, 1], [5, 7], trans),
                               mealy)
        assert text == jax_fsmio.print_nfa(
            jax_fsmio.TextNfa(11, 4, [0, 1], [5, 7], trans), mealy)
        assert _fields(fsmio.read_nfa(text, mealy)) == _fields(
            jax_fsmio.read_nfa(text, mealy))
    values = {
        "map": {3: 7, 1: -4, 9: 0},
        "multimap": {2: [5, 6], 0: [1], 7: [9, 9, 3]},
        "chain2num": [((1, 2, 3), 9), ((4,), -1), ((2, 2), 0)],
        "int_array": [5, -3, 0, 12],
        "str2int": [("hello", 3), ("wo rld", -2)],
    }
    for kind, v in values.items():
        text = getattr(fsmio, f"print_{kind}")(v)
        assert text == getattr(jax_fsmio, f"print_{kind}")(v)
        assert getattr(fsmio, f"read_{kind}")(text) == v
        assert getattr(jax_fsmio, f"read_{kind}")(text) == v
    # the builders' machines: a minimal DFA with perfect-hash weights and a
    # pattern lexer's automaton (the shipped wbd's grammar)
    from blingfire_tpu.compiler.mindfa import (assign_mph_ows as j_mph,
                                               build_min_dfa as j_min)
    from blingfire_tpu_torch.compiler.mindfa import (assign_mph_ows,
                                                     build_min_dfa)

    chains = sorted({tuple(W(w)) for w in _seeded_words(60) if w})
    n, final, edges = build_min_dfa(chains)
    jn, jfinal, jedges = j_min(chains)
    got = fsmio.from_min_dfa(n, final, edges, assign_mph_ows(n, final, edges))
    want = jax_fsmio.from_min_dfa(jn, jfinal, jedges,
                                  j_mph(jn, jfinal, jedges))
    assert fsmio.print_dfa(got, "mealy") == jax_fsmio.print_dfa(want, "mealy")


# ------------------------------------------------------------------ the CLI


def _cli(pkg: str, args: list[str], stdin: str, cwd: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", f"{pkg}.tools.cli"] + args,
                       input=stdin, capture_output=True, text=True, cwd=cwd,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


CLI_TEXT = ("Hello, world! This is a test.\nMr. Smith went to Washington. "
            "He left.\n\nhyphenation computer\nnaïve café 42 x\0y\n")


@pytest.fixture(scope="module")
def cli_models(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_models")
    blobs = {"gpt2.bin": testing.gpt2_shaped_model_bytes(600, n_long=10),
             "bert.bin": testing.bert_shaped_model_bytes(600),
             "syllab.bin": testing.syllab_shaped_model_bytes(300),
             "wbd.bin": testing.shipped_lexer_bytes("wbd"),
             "sbd.bin": testing.shipped_lexer_bytes("sbd")}
    for name, blob in blobs.items():
        (d / name).write_bytes(blob)
    (d / "pos.dict.utf8").write_text(
        "".join(f"{w}\tWORD_ID_{i + 1}\t{-float(i + 1)}\n"
                for i, w in enumerate(["a", "b", "ab", "▁a", "▁ab", "c"])),
        encoding="utf-8")
    return d


@pytest.mark.parametrize("cmd,model,extra", [
    ("words", "wbd.bin", []), ("sentences", "sbd.bin", []),
    ("ids", "gpt2.bin", []), ("ids", "bert.bin", ["--unk", "100"]),
    ("lex", "wbd.bin", []), ("hyph", "syllab.bin", []),
    ("inspect", "gpt2.bin", []), ("inspect", "bert.bin", []),
])
def test_cli_matches_jax(cmd, model, extra, cli_models):
    args = [cmd, "--ldb", str(cli_models / model)] + extra
    got = _cli("blingfire_tpu_torch", args, CLI_TEXT, str(cli_models))
    want = _cli("blingfire_tpu", args, CLI_TEXT, str(cli_models))
    assert got and got == want


def test_cli_build_dict_matches_jax(cli_models, tmp_path):
    out = {}
    for pkg in ("blingfire_tpu_torch", "blingfire_tpu"):
        d = tmp_path / pkg
        d.mkdir()
        args = ["build-dict", "--in", str(cli_models / "pos.dict.utf8"),
                "--out", "m.bin", "--tokalgo", "bpe-opt", "--id-offset", "-1"]
        out[pkg] = (_cli(pkg, args, "", str(d)), (d / "m.bin").read_bytes())
    assert out["blingfire_tpu_torch"] == out["blingfire_tpu"]
    assert out["blingfire_tpu"][0].startswith("wrote m.bin")


LEX_RULES = r"""
< [a-zA-Z]+ > --> WORD
< [0-9]+ > --> NUM
< [\x20\x09]+ > --> IGNORE
< . > --> WORD
"""


def test_cli_build_lex_matches_jax(tmp_path):
    (tmp_path / "rules.lex").write_text(LEX_RULES, encoding="utf-8")
    (tmp_path / "tagset.txt").write_text("WORD 1\nNUM 2\nIGNORE 4\n")
    out = {}
    for pkg in ("blingfire_tpu_torch", "blingfire_tpu"):
        d = tmp_path / pkg
        d.mkdir()
        args = ["build-lex", "--in", str(tmp_path / "rules.lex"), "--tagset",
                str(tmp_path / "tagset.txt"), "--out", "lex.bin"]
        msg = _cli(pkg, args, "", str(d))
        words = _cli(pkg, ["words", "--ldb", "lex.bin"], CLI_TEXT, str(d))
        out[pkg] = (msg, (d / "lex.bin").read_bytes(), words)
    assert out["blingfire_tpu_torch"] == out["blingfire_tpu"]
    assert out["blingfire_tpu"][2].startswith("Hello , ")
