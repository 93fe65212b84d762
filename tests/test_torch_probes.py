"""Port parity: the probe kernels of scripts/ against the port's plain
twins (gappadder_tpu_torch.probes, device="cpu").

Each script is loaded by path (scripts/ is no package). While its own
function runs, `pl.pallas_call` is replaced by a recorder that keeps
the kernel body and the call's specs and stops the script there; the
test then calls the real `pl.pallas_call(kernel, interpret=True,
**specs)` on seeded numpy inputs at the script's own shapes and demands
exact equality with the port. Nothing in scripts/ changes."""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gappadder_tpu_torch.probes import int16_repro, kernel_experiments as ke
from gappadder_tpu_torch.probes import swprobe
from gappadder_tpu_torch.testcases import (ARGMAX_INPUTS, INT16_LOOP_INPUTS,
                                           probe_input)

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"


class _Stop(Exception):
    pass


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_probe_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(mod, call):
    """The (kernel, specs) of every pallas_call that `call()` makes
    through `mod.pl`, each call stopped before it runs."""
    got = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(pl, name)

        @staticmethod
        def pallas_call(kernel, **specs):
            got.append((kernel, specs))

            def stop(*args):
                raise _Stop
            return stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "pl", Recorder())
        try:
            call()
        except _Stop:
            pass
    return got


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain twins run a thousand small tensor steps; one intra-op
    thread runs them faster than a pool that shares the host's cores
    with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def kernels():
    exp = _load("tpu_kernel_experiments")
    sw = _load("swprobe")
    repro = _load("mosaic_int16_repro")
    k = {name: _capture(exp, getattr(exp, name))[0]
         for name in ("exp_dynamic_sublane", "exp_int16_loop",
                      "exp_int32_loop_with_argmax")}
    x = swprobe.script_input()
    for level in swprobe.LEVELS:
        k[f"swprobe{level}"] = _capture(sw, lambda: sw.run(x, level))[0]
    # probe() reports the stop as a failed lowering and goes on
    k["elementwise"], k["roll"] = _capture(repro, repro.main)
    return k


def _pallas(kernel_specs, *args):
    kernel, specs = kernel_specs
    return np.asarray(pl.pallas_call(kernel, interpret=True, **specs)(*args))


def _int_recurrence(x, steps, floor):
    """The loops' recurrence in unbounded integers: h_last [S, W]."""
    h = x.astype(np.int64)
    e = h.copy()
    for _ in range(steps):
        e = np.maximum(h - 1, e - 1)
        h = np.maximum(np.roll(h, 1, 0) + 1, e)
        if floor is not None:
            h = np.maximum(h, floor)
    return h


def test_recorder_keeps_the_scripts_calls(kernels):
    assert jax.default_backend() == "cpu"
    for name in ("exp_int16_loop", "exp_int32_loop_with_argmax"):
        assert kernels[name][1]["out_shape"].shape == (ke.S, ke.TB)
    assert kernels["swprobe3"][1]["grid"] == (swprobe.NBT,
                                              swprobe.GRID_STEPS)
    assert kernels["swprobe3"][1]["out_shape"].shape == (
        1, swprobe.NBT * swprobe.TB)
    assert kernels["exp_dynamic_sublane"][1]["out_shape"].shape == (1, 128)


@pytest.mark.parametrize("j", [17, 0, 63, 64, 70, -1, -5, -70])
def test_dynamic_sublane_matches_pallas(kernels, j):
    t = probe_input("beyond_int16", (64, 128), seed=3)
    want = _pallas(kernels["exp_dynamic_sublane"],
                   np.array([[j]], np.int32), t)
    got = ke.exp_dynamic_sublane(t, j, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", INT16_LOOP_INPUTS)
def test_int16_loop_matches_pallas(kernels, case):
    x = probe_input(case, (ke.S, ke.TB), seed=1)
    want = _pallas(kernels["exp_int16_loop"], x)
    got = ke.exp_int16_loop(x, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    if case != "zeros":
        # int16 wrap-around decides the result: unbounded ints differ
        assert not np.array_equal(got, _int_recurrence(x, ke.STEPS, -16384))


@pytest.mark.parametrize("case", ARGMAX_INPUTS)
def test_int32_argmax_loop_matches_pallas(kernels, case):
    x = probe_input(case, (ke.S, ke.TB), seed=2)
    want = _pallas(kernels["exp_int32_loop_with_argmax"], x)
    out, am = ke.exp_int32_loop_with_argmax(x, device="cpu")
    np.testing.assert_array_equal(out.numpy(), want)
    # the argmax the JAX kernel drops: the last step's first row of the
    # max of float32(h)
    h = _int_recurrence(x, ke.STEPS, None)
    np.testing.assert_array_equal(am.numpy(),
                                  np.argmax(h.astype(np.float32), axis=0))
    f = h.astype(np.float32)
    assert ((f == f.max(axis=0)).sum(axis=0) > 1).any()    # ties met


@pytest.mark.parametrize("level", swprobe.LEVELS)
def test_swprobe_matches_pallas(kernels, level):
    x = swprobe.script_input(seed=0)
    want = _pallas(kernels[f"swprobe{level}"], x)
    got = swprobe.run(x, level, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_swprobe_levels_differ():
    """Each level's arithmetic reaches the output."""
    x = swprobe.script_input(seed=4)[:, :128]
    outs = [swprobe.run(x, level, nstep=48, device="cpu").numpy()
            for level in swprobe.LEVELS]
    np.testing.assert_array_equal(outs[0], (5 * x + 10).max(0, keepdims=True))
    for a, b in zip(outs, outs[1:]):
        assert not np.array_equal(a, b)


@pytest.mark.parametrize("kernel", ["elementwise", "roll"])
@pytest.mark.parametrize("case", ["script", "int16_full"])
def test_int16_repro_matches_pallas(kernels, kernel, case):
    x = (int16_repro.script_input() if case == "script" else
         probe_input("int16_full", int16_repro.SHAPE, seed=4))
    want = _pallas(kernels[kernel], x)
    got = getattr(int16_repro, kernel)(x, device="cpu").numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


_DEFAULTS = {
    "exp_dynamic_sublane": (
        lambda: ke.exp_dynamic_sublane(device="cpu"),
        lambda: (np.array([[ke.SUBLANE_ROW]], np.int32), ke.script_table())),
    "exp_int16_loop": (lambda: ke.exp_int16_loop(device="cpu"),
                       lambda: (np.zeros((ke.S, ke.TB), np.int32),)),
    "exp_int32_loop_with_argmax": (
        lambda: ke.exp_int32_loop_with_argmax(device="cpu")[0],
        lambda: (np.zeros((ke.S, ke.TB), np.int32),)),
    "swprobe3": (lambda: swprobe.run(device="cpu"),
                 lambda: (swprobe.script_input(),)),
    "elementwise": (lambda: int16_repro.elementwise(device="cpu"),
                    lambda: (int16_repro.script_input(),)),
    "roll": (lambda: int16_repro.roll(device="cpu"),
             lambda: (int16_repro.script_input(),)),
}


@pytest.mark.parametrize("key", list(_DEFAULTS))
def test_defaults_are_the_scripts_inputs(kernels, key):
    """With no input each entry point runs its script's own input."""
    run, args = _DEFAULTS[key]
    np.testing.assert_array_equal(run().numpy(),
                                  _pallas(kernels[key], *args()))


def _clamped_row(R: int, j: int) -> int:
    """The JAX kernel's row for index j: negative counts from the end,
    then the start clamps into [0, R - 1]."""
    return min(max(j + R if j < 0 else j, 0), R - 1)


@pytest.mark.parametrize("shape", [(9, 37), (5, 1), (6, 2051), (3, 6)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_dynamic_sublane_takes_any_width(shape):
    """Widths that are no multiple of the card's 4-int vector, so that
    rows start off it: the row read equals t[j] under the clamp."""
    t = probe_input("beyond_int16", shape, seed=sum(shape))
    R = shape[0]
    for j in (0, 1, R - 1, R, R + 5, -1, -R, -R - 3):
        got = ke.exp_dynamic_sublane(t, j, device="cpu").numpy()
        np.testing.assert_array_equal(got, t[_clamped_row(R, j)][None])


def _int16_views(shape, seed):
    """(name, view, its values as numpy): contiguous, 1 and 7 elements
    into a larger storage, and a strided column slice."""
    x = probe_input("int16_full", shape, seed)
    n = x.size
    flat = torch.from_numpy(probe_input("int16_full", (n + 8,), seed + 1))
    views = [("contiguous", torch.from_numpy(x))]
    for off in (1, 7):
        v = flat[off:off + n].view(shape)
        v.copy_(torch.from_numpy(x))
        views.append((f"offset{off}", v))
    wide = torch.from_numpy(probe_input("int16_full",
                                        (shape[0], 2 * shape[1]), seed + 2))
    views.append(("strided", wide[:, ::2]))
    return [(name, v, v.numpy().copy()) for name, v in views]


@pytest.mark.parametrize("shape", [(1, 7), (1025, 33), (3000, 41),
                                   (32, 4097), (2, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_int16_repro_takes_any_rows_width_and_view(shape):
    """One row, more than 1024 rows, odd widths, inputs off the start of
    their storage and strided: roll equals np.roll and elementwise the
    wrapping numpy max(x + 3, x - 2)."""
    for name, x, xn in _int16_views(shape, seed=shape[0]):
        got = int16_repro.roll(x, device="cpu").numpy()
        np.testing.assert_array_equal(got, np.roll(xn, 1, axis=0), name)
        got = int16_repro.elementwise(x, device="cpu").numpy()
        want = np.maximum((xn + np.int16(3)).astype(np.int16),
                          (xn - np.int16(2)).astype(np.int16))
        np.testing.assert_array_equal(got, want, name)


def test_probe_wrappers_refuse_other_dtypes_on_the_cpu():
    with pytest.raises(TypeError):
        int16_repro.roll(np.zeros((4, 4), np.int32), device="cpu")
    with pytest.raises(TypeError):
        int16_repro.elementwise(np.zeros((4, 4), np.int32), device="cpu")
    with pytest.raises(TypeError):
        ke.exp_dynamic_sublane(np.zeros((4, 4), np.int16), 1, device="cpu")
    with pytest.raises(ValueError, match=r"\[S, W\]"):
        int16_repro.roll(np.zeros(4, np.int16), device="cpu")


def test_swprobe_wraps_as_pallas_near_int32_max(kernels):
    """Near INT32_MAX every int32 add of the ladder wraps (x + 4, A + 1,
    the sum of A-E): level 3's plain twin wraps as the Pallas kernel
    does."""
    x = probe_input("near_int32_max", (swprobe.S, swprobe.NBT * swprobe.TB),
                    seed=5)
    want = _pallas(kernels["swprobe3"], x)
    got = swprobe.run(x, 3, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    sums = x.astype(np.int64) * 5 + 10
    assert (sums > np.iinfo(np.int32).max).all()     # the initial sum wraps
