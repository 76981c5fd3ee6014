"""The run's environment: the program's plan switches pinned, and the guard
that no JAX or JAX package was loaded, compared by whole top-level names."""
import os
import subprocess
import sys

from perfbench import env
from perfbench.tests.conftest import ROOT


def test_guard_compares_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro", "repro.models",
              "repro_torch", "repro_torch.serving", "jaxtyping", "reprocess", "perfbench"]
    assert env.forbidden_modules(loaded) == ["flax", "jax", "jaxlib", "repro"]
    assert env.forbidden_modules(["repro_torch.models.transformer", "torch", "numpy"]) == []


def test_a_run_loads_no_jax():
    """What a run imports (the harness, the serve driver, the faults, the
    reference and the program's serving) loads neither JAX nor the JAX
    package."""
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
            "import perfbench.run, perfbench.kinds.serve_closed, perfbench.faults\n"
            "import perfbench.controls, perfbench.reference.decoder\n"
            "import repro_torch.serving, repro_torch.models\n"
            "from perfbench import env, manifest\n"
            "for m in manifest.Manifest(manifest.HERE.parent).data['per_layer']:\n"
            "    manifest.metric(m['name'])\n"
            "print(env.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT),
                                                           src=str(ROOT / "src"))],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_pin_unsets_the_plan_switches(tmp_path):
    environ = {"REPRO_AUTOTUNE": "1", "REPRO_TORCH_GEMM_PLAN": "schedule=simt",
               "REPRO_TORCH_DECODE_SPLITS": "4", "REPRO_AUTOTUNE_CACHE": "/elsewhere.json",
               "TMPDIR": str(tmp_path), "KEEP": "x"}
    env.pin(environ)
    assert not set(env.PLAN_SWITCHES) & set(environ) and environ["KEEP"] == "x"
    cache = environ["REPRO_AUTOTUNE_CACHE"]
    assert cache.startswith(str(tmp_path)) and not os.path.exists(cache)
