"""The port's train launcher runs without jax and without the reference
(``test_torch_isolation_serve.py``'s ``run_isolated``): every family
trains reduced on the CPU, the dense family also on 2 gloo ranks of the
cube and in 2 pipeline stages.  The pipeline run (``--pp 2
--host-devices 2``, 2 microbatches) imports ``repro_torch.core.pipeline``
and its losses are held within 1e-4 of the same run on one device at pp
1 with the same 2 microbatches.  The dry run (``repro_torch.launch.
dryrun``) lowers one plan the same way.
"""
import json

import pytest

from test_torch_isolation_serve import run_isolated

TRAIN = ["'--reduced', '--device', 'cpu', '--log-every', '1'"]
# each case: the train launcher's arch and flags, and how many losses it
# logs (one per step at --log-every 1)
TRAIN_CASES = {
    "dense": [(["--arch", "tinyllama-1.1b", "--steps", "2", "--batch", "2",
                "--seq", "32"], 2),
              (["--arch", "zamba2-1.2b", "--steps", "1", "--batch", "1",
                "--seq", "96"], 1)],
    "cube": [(["--arch", "tinyllama-1.1b", "--steps", "1", "--batch", "2",
               "--seq", "32", "--model", "2", "--host-devices", "2"], 1)],
    "families": [([("--arch"), arch, "--steps", "1", "--batch", "2",
                   "--seq", "32"], 1)
                 for arch in ("mixtral-8x7b", "internvl2-2b",
                              "whisper-medium")]}


@pytest.mark.parametrize("group", sorted(TRAIN_CASES))
def test_train_launcher_imports_no_jax(group):
    run_isolated([
        "import repro_torch.kernels.ssd_scan, repro_torch.checkpoint.store",
        "import repro_torch.launch.mesh, repro_torch.launch.ranks",
        "import repro_torch.core.comm, repro_torch.core.topology",
        "from repro_torch.launch.train import main as train",
        f"for argv, n in {TRAIN_CASES[group]!r}:",
        f"    out = train(argv + [{TRAIN[0]}])",
        "    assert len(out['losses']) == n, (argv, out)"])


def test_pipeline_launcher_matches_one_device_and_imports_no_jax():
    common = ("['--arch', 'tinyllama-1.1b', '--steps', '2', '--batch', "
              "'4', '--seq', '32', '--microbatch', '2', " + TRAIN[0] + "]")
    out = run_isolated([
        "import json",
        "import repro_torch.core.pipeline",
        "from repro_torch.launch.train import main as train",
        f"pp2 = train({common} + ['--pp', '2', '--host-devices', '2'])",
        f"one = train({common} + ['--host-devices', '1'])",
        "print('LOSSES', json.dumps([pp2['losses'], one['losses']]))"])
    line = next(x for x in out.splitlines() if x.startswith("LOSSES "))
    pp2, one = json.loads(line[len("LOSSES "):])
    assert len(pp2) == len(one) == 2, (pp2, one)
    assert max(abs(a - b) for a, b in zip(pp2, one)) <= 1e-4, (pp2, one)
    assert "'pp': 2" in out and "'bubble_fraction': 0.5" in out


def test_dryrun_imports_no_jax():
    """The dry run's module and one ``--lower-only`` plan (deepseek-v3 at
    the production layout: its memory model) in a fresh interpreter: no
    jax, no reference."""
    out = run_isolated([
        "from repro_torch.launch.dryrun import main as dryrun",
        "rc = dryrun(['--arch', 'deepseek-v3-671b', '--shape', 'train_4k',"
        " '--lower-only'])",
        "assert rc == 0, rc"])
    assert "deepseek-v3-671b x train_4k x 1pod [3d]" in out
    assert " LOWERED" in out and "mem/device opt" in out
