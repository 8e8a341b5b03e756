"""Runtime plumbing: device peak table, compile-cache location, device
memory budget."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3",
                                  "NVIDIA H100 PCIe"])
def test_roofline_known_h100(kind):
    from nextpolish_tpu.runtime.roofline import device_peaks

    flops, bw, got = device_peaks(kind)
    # FP32 CUDA-core rates (the chain DP has no tensor-core work)
    assert got == kind and 5e13 <= flops < 1e14 and bw >= 2e12


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100"])
def test_roofline_unknown_device_raises(kind):
    from nextpolish_tpu.runtime.roofline import device_peaks

    with pytest.raises(KeyError):
        device_peaks(kind)


def _cache_dir(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import nextpolish_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, check=True, cwd="/")
    return out.stdout.strip()


def test_compile_cache_env_wins(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) \
        == str(tmp_path)


def test_compile_cache_default_in_checkout():
    assert _cache_dir({}) == os.path.join(REPO, ".jax_cache")


def test_device_budget_cpu_uses_host_memory():
    from nextpolish_tpu.runtime import budget

    assert budget.device_free_bytes() == pytest.approx(
        budget.host_available_bytes(), rel=0.2)
