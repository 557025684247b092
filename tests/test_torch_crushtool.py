"""The port's crushtool (ceph_tpu_torch/tools/crushtool.py) prints what
the reference's crushtool prints on the same map file: the compiled text,
and the --test transcript (mappings, bad mappings, utilization) with the
port mapping on the CPU.  The same transcript on the card is
chip_smoke.py's crushtool phase."""
import io

import pytest
import torch

from ceph_tpu.tools import crushtool as jax_crushtool
from ceph_tpu_torch.tools import crushtool


def _run(tool, argv):
    out = io.StringIO()
    rc = tool.main(argv, out=out)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def mapfile(tmp_path_factory):
    path = tmp_path_factory.mktemp("crush") / "map.txt"
    rc, _ = _run(jax_crushtool, ["--build", "12", "3", "-o", str(path)])
    assert rc == 0
    return str(path)


def test_build_and_compile_match(mapfile):
    assert _run(crushtool, ["--build", "12", "3"]) == _run(jax_crushtool, ["--build", "12", "3"])
    assert _run(crushtool, ["-i", mapfile, "-c"]) == _run(jax_crushtool, ["-i", mapfile, "-c"])


def test_test_transcript_matches(mapfile):
    argv = ["-i", mapfile, "--test", "--rule", "0", "--num-rep", "4", "--max-x", "299",
            "--show-mappings", "--show-utilization", "--show-bad-mappings",
            "--weight", "5", "0", "--weight", "7", "0.5"]
    rc, want = _run(jax_crushtool, argv)
    assert rc == 0 and "CRUSH rule 0 x 299 [" in want
    assert _run(crushtool, argv + ["--device", "cpu"]) == (0, want)


def test_test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(crushtool, ["--build", "4", "2", "--test", "--max-x", "3"])
