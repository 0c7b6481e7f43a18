"""The kernels' build records on the CPU: the ptxas report kept beside
each built library (``_build.ptxas_log``) and ``chip_smoke.py``'s reading
of it, which fails a tensor-core kernel that spills or has no report."""
import importlib.util
from pathlib import Path

import pytest

from mxtpu_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent

# a ptxas -v report of two instantiations, one of them spilling
REPORT = """\
ptxas info    : Compiling entry function '_Z4kernILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z4kernILi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 64 bytes smem
ptxas info    : Compiling entry function '_Z4kernILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z4kernILi128EEvv
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 64 bytes smem
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers
"""


@pytest.fixture
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ptxas_of_reads_registers_and_spills_of_each_instantiation(smoke):
    assert smoke.ptxas_of(REPORT, "kern") == [[168, 0], [255, 16]]
    assert smoke.ptxas_of(REPORT, "other") == [[32, 0]]
    assert smoke.ptxas_of("", "kern") == []


def test_the_report_is_kept_beside_the_library(monkeypatch, tmp_path):
    # this process's build first, else the log kept beside an earlier
    # build's library, else nothing
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build_log", {})
    lib = _build._target("conv_nhwc")
    assert lib.parent == tmp_path and _build.ptxas_log("conv_nhwc") == ""
    _build._log_path(lib).write_text(REPORT)
    assert _build._log_path(lib).name == lib.stem + ".log"
    assert _build.ptxas_log("conv_nhwc") == REPORT
    _build.build_log["conv_nhwc"] = "this run's"
    assert _build.ptxas_log("conv_nhwc") == "this run's"
