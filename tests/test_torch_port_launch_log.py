"""The port's launch log (``csrc/launch_log.cu``): every kernel launch in
``csrc/`` notes its kernel, and ``_build.kernels_launched`` reads the
names back. The kernels cannot run here; the sources and the Python side
of the log are checked on the CPU."""

import ctypes
import glob
import os
import re

import pytest

from world_modelz_tpu_torch.kernels import _build

LAUNCH = re.compile(r"^\s*([A-Za-z_]\w*(?:<[^<>]*>)?)<<<")


def _sources():
    return sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))
                  + glob.glob(os.path.join(_build.CSRC, "*.cuh")))


@pytest.mark.parametrize("path", _sources(), ids=os.path.basename)
def test_every_launch_notes_its_kernel(path):
    """Each ``kernel<<<...>>>``, cooperative and ``cudaLaunchKernelEx`` launch is preceded by
    ``wmz::note_launch`` of the same kernel, so the log names every
    kernel the library launches."""
    lines = open(path).read().splitlines()
    for i, line in enumerate(lines):
        m = LAUNCH.match(line)
        if m:
            assert f"wmz::note_launch({m.group(1)});" in lines[i - 1], (
                f"{os.path.basename(path)}:{i + 1} launches {m.group(1)} unnoted")
        if "cudaLaunchCooperativeKernel(p.kernel" in line:
            assert "wmz::note_launch(p.kernel);" in lines[i - 1]
        if "cudaLaunchKernelEx(" in line:
            assert "wmz::note_launch(" in lines[i - 1], (
                f"{os.path.basename(path)}:{i + 1} launches unnoted")


class _FakeLog:
    """The two C entries of the log, over a list of demangled names."""

    def __init__(self, names):
        self.names, self.resets = names, 0

    def wmz_launch_log_reset(self):
        self.resets += 1

    def wmz_launch_log(self, buf, cap):
        text = "".join(n + "\n" for n in self.names).encode()
        if len(text) + 1 > cap:
            return -1
        ctypes.memmove(buf, text, len(text))
        return len(self.names)


def test_kernels_launched_reads_the_log(monkeypatch):
    names = ["void (anonymous namespace)::flash_fwd_tf32_kernel<64>(float const*)",
             "(anonymous namespace)::vq_stats_kernel(float const*, int)"]
    lib = _FakeLog(names)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    calls = []
    assert _build.kernels_launched(lambda: calls.append(1)) == names
    assert calls == [1] and lib.resets == 1
    lib.names = ["x" * (1 << 16)]
    with pytest.raises(RuntimeError, match="launch log"):
        _build.kernels_launched(lambda: None)


def test_the_log_is_bound():
    assert _build._SIGNATURES["wmz_launch_log_reset"] == ([], None)
    argtypes, restype = _build._SIGNATURES["wmz_launch_log"]
    assert restype is ctypes.c_int and len(argtypes) == 2
