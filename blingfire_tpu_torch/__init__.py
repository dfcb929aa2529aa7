"""blingfire_tpu_torch — the PyTorch/CUDA port of blingfire_tpu.

Public surface, as the JAX package's:
  api          — product API (TextToIds/Words/Sentences/Hashes… per
                 blingfiretokdll.h:25-103); its batch calls run on the card
                 (``api.load_model(path).text_to_ids_batch(docs)``)
  compat       — drop-in mirror of the reference `blingfire` python binding
  compiler     — offline model compilers (lex, dict, wordpiece, hyph, morph)
  entry        — the flagship's forward step and a multi-GPU dry run
  load_morph   — legacy morphology LDB loader (guessers, HMM tagger,
                 stemmer, tag dict, WRE parser; FAMorphLDB_t_packaged.h)

The device work runs in hand-written CUDA kernels (``kernels/``).  The
package imports ``torch`` and never ``jax`` or anything of
``blingfire_tpu``.
"""

from .runtime.morph import MorphLdb, load_morph, load_regexp_tags  # noqa: F401
