"""Nothing the benchmark runs loads the JAX package or JAX; the reference
and the comparison load nothing of the program."""
from __future__ import annotations

import json
import subprocess
import sys

from bench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(modules) -> set:
    code = ("import sys, json\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_bench_module_loads_no_jax():
    mods = sorted("bench." + ".".join(p.relative_to(ROOT / "bench")
                                      .with_suffix("").parts)
                  for p in (ROOT / "bench").rglob("*.py")
                  if "tests" not in p.parts and "metrics" not in p.parts
                  and p.name != "__init__.py")
    assert "bench.run" in mods and "bench.reference.search" in mods
    loaded = _loaded(mods + ["repro_torch.core.builder",
                             "repro_torch.core.engine"])
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(["bench.reference.search", "bench.check"])
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_forbidden_modules_compares_whole_top_level_names():
    code = (f"import sys, types; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT)!r}]\n"
            "from bench import harness\n"
            "import repro_torch\n"
            "assert harness.forbidden_modules() == [], "
            "harness.forbidden_modules()\n"
            "sys.modules['repro.core'] = types.ModuleType('repro.core')\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "['repro']"
