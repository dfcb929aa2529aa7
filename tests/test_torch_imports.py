"""The port imports neither JAX nor anything of the JAX package, and its
entry points run on the card unless asked for the CPU."""

from __future__ import annotations

import inspect
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import blingfire_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "blingfire_tpu" or m.startswith("blingfire_tpu."))
print(len(names), "modules;", "forbidden:", bad)
assert not bad, bad
assert len(names) >= 20, names
new = {"blingfire_tpu_torch.ops.unigram", "blingfire_tpu_torch.ops.dfloat",
       "blingfire_tpu_torch.ops.lexer", "blingfire_tpu_torch.runtime.wp_hybrid",
       "blingfire_tpu_torch.runtime.lexer", "blingfire_tpu_torch.runtime.casefold",
       "blingfire_tpu_torch.compiler.wordpiece",
       "blingfire_tpu_torch.runtime.lexer_host",
       "blingfire_tpu_torch.compiler.lexbin",
       "blingfire_tpu_torch.native.gen_default_models",
       "blingfire_tpu_torch.ops.hyph", "blingfire_tpu_torch.runtime.hyph",
       "blingfire_tpu_torch.compiler.hyphpats",
       # the classic doc-row path: new or changed in it
       "blingfire_tpu_torch.ops.bpe", "blingfire_tpu_torch.runtime.host",
       "blingfire_tpu_torch.runtime.dedup", "blingfire_tpu_torch.native",
       "blingfire_tpu_torch.kernels", "blingfire_tpu_torch.runtime.metrics",
       "blingfire_tpu_torch.testing",
       # the data-parallel runners
       "blingfire_tpu_torch.parallel", "blingfire_tpu_torch.parallel.mesh",
       # the product API, its drop-in layer, the entry points and the
       # host-only modules
       "blingfire_tpu_torch.api", "blingfire_tpu_torch.compat",
       "blingfire_tpu_torch.entry", "blingfire_tpu_torch.runtime.normalize",
       "blingfire_tpu_torch.runtime.transforms",
       "blingfire_tpu_torch.runtime.morph",
       "blingfire_tpu_torch.compiler.fsmio",
       "blingfire_tpu_torch.compiler.morphbin",
       "blingfire_tpu_torch.tools", "blingfire_tpu_torch.tools.cli"}
assert new <= set(names), names
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda():
    from blingfire_tpu_torch import api, entry
    from blingfire_tpu_torch.ops import bpe, hyph, lexer, unigram
    from blingfire_tpu_torch.parallel import mesh
    from blingfire_tpu_torch.runtime.host import SpTokenizer
    from blingfire_tpu_torch.runtime.hyph import HyphTpu
    from blingfire_tpu_torch.runtime.lexer_host import LexerTpu
    from blingfire_tpu_torch.runtime.wp_hybrid import WordPieceHybrid

    for fn in (SpTokenizer.__init__, bpe.make_device_tables,
               unigram.make_device_tables, WordPieceHybrid.__init__,
               lexer.make_device_tables, lexer.make_dense_sub,
               LexerTpu.__init__, hyph.make_device_tables,
               HyphTpu.__init__, mesh.init_group, api.TokenizerHandle.__init__,
               entry.entry, entry.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
