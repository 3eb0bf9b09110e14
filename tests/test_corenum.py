"""`-C corenum` output-permutation parity vs the reference binary.

The reference's -C spawns no threads; it only round-robins each DNA
record's triplexes into corenum buckets and concatenates the buckets
(Fasim-LongTarget.cpp:129-163).  With multi-record DNA this permutes
TFOsorted row order within sort-tie classes (non-stable class sort,
:813,:847-850), so byte parity requires emulating the permutation.
Differential: patched-canonical oracle (multi-record readDna fix) vs our
CLI on the 3-record MEG3 subset, corenum 2 and 3.
"""
import filecmp
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ORACLE, REFERENCE, oracle_bin


@pytest.mark.parametrize("corenum", [2, 3])
def test_corenum_matches_oracle(tmp_path, corenum):
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference tree not available (builds the oracle)")
    fasim = oracle_bin("fasim_patched")
    for f in ("meg3sub3.fa", "MEG3.fa"):
        shutil.copy(os.path.join(ORACLE, f), tmp_path)
    ref_out = tmp_path / "ref"
    our_out = tmp_path / "our"
    ref_out.mkdir()
    our_out.mkdir()
    subprocess.run(
        [fasim, "-f1", "meg3sub3.fa", "-f2", "MEG3.fa", "-O", "ref/",
         "-C", str(corenum)],
        cwd=tmp_path, check=True, capture_output=True, timeout=300)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(ORACLE)
    subprocess.run(
        [sys.executable, "-m", "fasim_tpu.cli", "-f1", "meg3sub3.fa",
         "-f2", "MEG3.fa", "-O", "our/", "-C", str(corenum)],
        cwd=tmp_path, env=env, check=True, capture_output=True, timeout=600)
    expected = sorted(os.listdir(ref_out))
    assert sorted(os.listdir(our_out)) == expected
    for name in expected:
        assert filecmp.cmp(ref_out / name, our_out / name,
                           shallow=False), f"-C {corenum}: {name} differs"
