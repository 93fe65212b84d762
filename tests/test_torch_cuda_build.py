"""The kernels' one binding (`ops/cuda_build.bind` and `launch`) on a
fake library, on the CPU: an entry's types are set once, the call gets
the card's current stream (and the card's index where the entry makes
the card current itself), and a non-zero cudaError raises naming the
entry. And each wrapper's `ARGS` against its C entry's parameters in
`csrc/`, which only a card would otherwise check."""

import contextlib
import ctypes
import re

import pytest
import torch

from gappadder_tpu_torch import probes
from gappadder_tpu_torch.ops import cuda_build, evaluate_dp, psort, sw_cuda

# every C entry of each csrc/<lib>.cu with the wrapper's ARGS
ENTRIES = {"sort": {"psort_launch": psort.ARGS},
           "sw": {"sw_batch_launch": sw_cuda.ARGS},
           "evaluate": {"evaluate_launch": evaluate_dp.ARGS},
           "probes": {f"probe_{n}": a for n, a in probes._ARGS.items()}}
C_CODES = {"void*": "p", "const void*": "p", "int": "i", "long long": "q"}


class FakeEntry:
    """A C entry that records its calls and returns the given codes."""

    def __init__(self, name, codes=()):
        self.__name__ = name
        self.codes = list(codes)
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.codes.pop(0)


class FakeLib:
    """A loaded library whose every attribute lookup is counted."""

    def __init__(self, codes=()):
        self.lookups = []
        self.codes = codes

    def __getattr__(self, name):
        self.lookups.append(name)
        return FakeEntry(name, self.codes)


def test_bind_sets_the_types_once(monkeypatch):
    lib = FakeLib()
    loads = []
    monkeypatch.setattr(cuda_build, "_bound", {})
    monkeypatch.setattr(cuda_build, "load",
                        lambda name: loads.append(name) or lib)
    fn = cuda_build.bind("fake", "fake_launch", "piq")
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert cuda_build.bind("fake", "fake_launch", "piq") is fn
    assert cuda_build.bind(lib, "fake_launch", "piq") is not fn
    assert loads == ["fake"] and lib.lookups == ["fake_launch"] * 2


def test_launch_passes_the_stream_and_raises_naming_the_entry(monkeypatch):
    current = []

    @contextlib.contextmanager
    def device(index):
        current.append(index)
        yield
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    fn = FakeEntry("fake_launch", codes=(0, 0, 700))
    cuda_build.launch(fn, 3, 11, 12)
    assert fn.calls == [(11, 12, 1003)] and current == [3]
    cuda_build.launch(fn, 2, 11, 12, sets_device=True)
    assert fn.calls[-1] == (11, 12, 2, 1002) and current == [3]
    with pytest.raises(RuntimeError,
                       match=r"^fake_launch: kernel launch failed "
                             r"\(cudaError 700\)$"):
        cuda_build.launch(fn, 0, 11, 12)


@pytest.mark.parametrize("lib", sorted(ENTRIES))
def test_args_match_the_c_entries(lib):
    """Each exported entry's parameter types, read from the source, are
    the wrapper's ARGS and then the stream; no entry lacks its ARGS."""
    src = (cuda_build.CSRC / f"{lib}.cu").read_text()
    found = dict(re.findall(
        r'^(?:extern "C" )?int (probe_\w+|\w+_launch)\(([^)]*)\)', src,
        re.M))
    assert sorted(found) == sorted(ENTRIES[lib])
    for entry, params in found.items():
        types = [" ".join(p.split()[:-1]) for p in params.split(",")]
        assert types[-1] == "void*", entry             # the stream
        assert "".join(C_CODES[t] for t in types[:-1]) == \
            ENTRIES[lib][entry], entry
