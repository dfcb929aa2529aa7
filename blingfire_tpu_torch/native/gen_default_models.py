# Copy of blingfire_tpu/native/gen_default_models.py; it writes the file
# named by its argument (atomically), so the build puts it in the build
# directory and nothing generated lands in the package.
"""Regenerate default_models.cxx: the compiled-in default wbd/sbd byte
arrays (the reference links BlingFireTokLibWbdData.cxx/SbdData.cxx the same
way, blingfiretokdll.cpp:27-31).  Sources are OUR compiler's output in
blingfire_tpu_torch/models_data/ (byte copies of the JAX package's models,
built from the reference ldbsrc lex rules by compiler/lexbin.py).

    python3 gen_default_models.py OUT.cxx
"""

from __future__ import annotations

import os
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
_MODELS = os.path.join(_DIR, "..", "models_data")


def emit(name: str, data: bytes, out: list[str]) -> None:
    # "extern": const namespace-scope objects otherwise get internal linkage
    out.append(f"extern const unsigned int {name}_size = {len(data)};")
    out.append(f"extern const unsigned char {name}[] = {{")
    for i in range(0, len(data), 20):
        out.append(",".join(str(b) for b in data[i : i + 20]) + ",")
    out.append("};")


def main(path: str) -> None:
    out = [
        "// GENERATED by gen_default_models.py — do not edit.",
        "// Compiled-in default wbd/sbd models (framework-built binaries).",
        'extern "C" {',
    ]
    for model, sym in (("wbd", "g_dumpBlingFireTokLibWbdData"),
                       ("sbd", "g_dumpBlingFireTokLibSbdData")):
        data = open(os.path.join(_MODELS, f"{model}.bin"), "rb").read()
        emit(sym, data, out)
    out.append("}")
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("\n".join(out) + "\n")
    os.replace(tmp, path)


if __name__ == "__main__":
    main(sys.argv[1])
