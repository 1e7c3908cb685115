"""What the benchmark loads: never JAX or the JAX package, and from its
reference nothing of the program. Names are compared whole, by the part
before the first dot, since the port's name begins with the JAX
package's."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "optax", "leastereo_tpu"}

_PROBE = """
import importlib, importlib.util, json, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
for name in sys.argv[2:]:
    importlib.import_module(name)
if {metrics}:
    for path in sorted((root / "benchmark" / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location("m_" + path.stem, path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(modules: list[str], metrics: bool) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(metrics=metrics), str(ROOT), *modules],
        capture_output=True, text=True, check=True, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"},
    )
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules(sub: str) -> list[str]:
    return [f"benchmark.{sub}.{p.stem}" for p in sorted((ROOT / "benchmark" / sub).glob("*.py")) if p.stem != "__init__"]


def test_harness_loads_no_jax():
    names = ["benchmark.run", "benchmark.harness", "benchmark.calibrate", "benchmark.program",
             "leastereo_tpu_torch", *_modules("drivers"), *_modules("reference")]
    top = loaded(names, metrics=True)
    assert "leastereo_tpu_torch" in top
    assert not top & BANNED, top & BANNED


def test_reference_loads_no_program():
    top = loaded(_modules("reference"), metrics=False)
    assert "torch" in top
    assert not top & (BANNED | {"leastereo_tpu_torch"}), top & (BANNED | {"leastereo_tpu_torch"})
