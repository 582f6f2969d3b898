"""The port's serve launcher runs without jax and without the reference:
each test runs launcher calls in a fresh interpreter and asserts that
neither ``jax`` nor a ``repro.*`` module was imported
(``test_torch_serve.py::test_port_imports_no_jax_and_no_reference``
imports every module; ``test_torch_isolation_train.py`` holds the train
launcher's calls).  Every family serves 3 requests of 4 new tokens,
reduced, on the CPU, and tinyllama-1.1b through each serving path.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_JAX = [
    "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')",
    "       or m == 'repro' or m.startswith('repro.')]",
    "assert not bad, bad",
    "print('NO-JAX-OK')"]


def run_isolated(lines, timeout: float = 240) -> str:
    """Run ``lines`` (after ``import sys``) in a fresh interpreter with
    the port on its path, then assert that no jax or reference module was
    imported; its standard output."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c",
                        "\n".join(["import sys", *lines, *NO_JAX])],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO-JAX-OK" in r.stdout
    return r.stdout


# each case: the serve launcher's flags (the arch tinyllama-1.1b unless
# they name one), three requests of 4 new tokens
SERVE_CASES = {
    "tinyllama": [[], ["--prefix-cache", "--shared-prefix", "20"],
                  ["--draft", "tinyllama-1.1b"], ["--no-fused-decode"]],
    "state": [["--arch", "zamba2-1.2b"], ["--arch", "xlstm-350m"]],
    "moe": [["--arch", "mixtral-8x7b"], ["--arch", "moonshot-v1-16b-a3b"]],
    "modality": [["--arch", "internvl2-2b"], ["--arch", "whisper-medium"]]}


@pytest.mark.parametrize("group", sorted(SERVE_CASES))
def test_serve_launcher_imports_no_jax(group):
    run_isolated([
        "import repro_torch.serve.speculate, repro_torch.serve.kvcache",
        "import repro_torch.models.mamba2, repro_torch.models.xlstm",
        "import repro_torch.models.moe, repro_torch.models.mla",
        "import repro_torch.models.encdec, repro_torch.models.frontend",
        "from repro_torch.launch.serve import main",
        f"for extra in {SERVE_CASES[group]!r}:",
        "    arch = [] if extra[:1] == ['--arch'] else ['--arch',",
        "                                             'tinyllama-1.1b']",
        "    stats = main(arch + extra + ['--reduced', '--device', 'cpu',",
        "                 '--requests', '3', '--max-new', '4'])",
        "    assert stats['tokens'] == 12, (extra, stats['tokens'])"])
