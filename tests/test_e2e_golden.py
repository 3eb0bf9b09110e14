"""End-to-end byte-parity: full pipeline vs reference golden outputs."""

import filecmp
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ORACLE, REFERENCE

GOLDEN = os.path.join(ORACLE, "golden")


@pytest.mark.parametrize("case,f1,f2,extra", [
    ("h19_lg40", "testDNA.fa", "H19.fa", ["-lg", "40"]),
    ("h19_default", "testDNA.fa", "H19.fa", []),
    # multi-record DNA (3 records of the MEG3 example): legacy-correct
    # readDna semantics vs the patched-canonical oracle (SURVEY.md §0, §4)
    ("meg3_sub3", "meg3sub3.fa", "MEG3.fa", []),
    # exact SIM engine (-F) on truncated inputs (full demo takes ~2 min)
    ("h19F_trunc", "testDNAt.fa", "H19t.fa", ["-F", "-lg", "40"]),
    # truncated NEAT1 (long-query family; full 22.7 knt parity against
    # oracle/golden/neat1 runs on the GPU in chip_smoke.py)
    ("neat1t", "testDNA.fa", "NEAT1t.fa", []),
    # -F with the SIM forward scan on device (kernels/sim_dev.py) and
    # the host replaying only the node list + extraction
    ("h19F_trunc@simdev", "testDNAt.fa", "H19t.fa", ["-F", "-lg", "40"]),
])
def test_demo_byte_identical(tmp_path, case, f1, f2, extra):
    sim_dev = case.endswith("@simdev")
    case = case.split("@")[0]
    golden_dir = os.path.join(GOLDEN, case)
    shutil.copy(os.path.join(ORACLE, f1), tmp_path)
    shutil.copy(os.path.join(ORACLE, f2), tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(ORACLE)
    if sim_dev:
        env["FASIM_SIM_DEVICE"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "fasim_tpu.cli", "-f1", f1,
         "-f2", f2, "-O", "out/", "--tpu-stdout-compat", "true", *extra],
        cwd=tmp_path, env=env, check=True, capture_output=True, timeout=600)
    produced = sorted(os.listdir(out))
    expected = sorted(f for f in os.listdir(golden_dir) if f != "stdout.txt")
    assert produced == expected
    for name in expected:
        assert filecmp.cmp(out / name, os.path.join(golden_dir, name),
                           shallow=False), f"{case}/{name} differs"
    # stdout compat: every line except the wall-clock one must match
    golden_stdout = os.path.join(golden_dir, "stdout.txt")
    if os.path.exists(golden_stdout):
        def strip(text):
            return [ln for ln in text.splitlines()
                    if not ln.startswith("Running time is")]

        with open(golden_stdout) as f:
            assert strip(r.stdout.decode()) == strip(f.read()), case
