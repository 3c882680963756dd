"""Kernel K1 of the port (fused local step) held against the reference.

On the CPU the port's plain version ``repro_torch.kernels.ref.fused_step_ref``
(what ``ops.fused_local_step`` runs for CPU tensors) is compared with the
reference's jnp oracle ``repro.kernels.ref.fused_step_ref`` and with the
reference's Pallas kernel run in interpret mode (``repro.kernels.ops``), on
the same numpy inputs, over the kind × schedule × clip × global/local × wd ×
h × s matrix at ragged n.

Tolerance: 4 fp32 ulp of the largest magnitude in each output. Both sides
run the same fp32 operations in the same order, but XLA's CPU backend may
contract a mul+add into one FMA (the interpret-mode Pallas kernel does, for
m' = β₁m + g) and its ``pow`` (in the debias β_t) may round differently from
torch's. One such rounding is at most an ulp of the operands, which shows as
many ulps of a result that cancels towards 0; so the bound is on the scale of
the operands, not of each element.

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scaled_update as su

torch.set_num_threads(1)

ULP_TOL = 4 * np.finfo(np.float32).eps

# (kind, schedule, clip, d, update_d, wd, h, s) — every axis takes each of its
# values in some case; d is "global" (n,), "local" (M, n) or None
CASES = [
    ("identity", "const", "max", None, False, 0.0, False, False),
    ("identity", "const", "max", None, False, 0.01, False, True),
    ("adam", "debias", "max", "global", False, 0.0, False, False),
    ("adam", "debias", "max", "local", True, 0.0, False, False),
    ("adam", "debias", "add", "local", True, 0.01, False, True),
    ("adam", "const", "max", "local", True, 0.0, True, False),
    ("adam", "debias", "add", "global", False, 0.01, False, True),
    ("rmsprop", "const", "max", "local", True, 0.0, False, True),
    ("rmsprop", "const", "add", "global", False, 0.0, False, False),
    ("rmsprop", "debias", "max", "local", True, 0.01, True, False),
    ("adagrad", "const", "max", "local", True, 0.0, False, False),
    ("adagrad", "const", "add", "local", True, 0.01, True, True),
    ("adagrad", "const", "max", "global", False, 0.0, False, True),
    ("oasis", "const", "max", "local", True, 0.0, True, False),
    ("oasis", "debias", "add", "local", True, 0.01, True, True),
]
IDS = ["-".join(str(v) for v in c) for c in CASES]


def _inputs(case, M=3, n=1001, seed=0):
    kind, schedule, clip, dmode, update_d, wd, has_h, has_s = case
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    x = {"p": f(M, n), "m": f(M, n), "g": f(M, n)}
    if dmode == "local":
        # signed D for the rule-3 kind, D² >= 0 otherwise
        x["d"] = f(M, n) if kind == "oasis" else np.abs(f(M, n))
    elif dmode == "global":
        x["d"] = np.abs(f(n))
    if has_h:
        x["h"] = f(M, n) if kind == "oasis" else f(M, n) ** 2
    x["t"] = rng.integers(0, 50, size=M).astype(np.int32)
    if has_s:
        x["s"] = rng.uniform(0.1, 1.0, size=M).astype(np.float32)
    kw = dict(gamma=0.05, beta1=0.9, weight_decay=wd, alpha=1e-2,
              beta2=0.99, kind=kind, clip=clip, schedule=schedule,
              update_d=update_d)
    return x, kw


def _args(x, conv):
    return [conv(x[k]) if k in x else None
            for k in ("p", "m", "g", "d", "h", "t", "s")]


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ULP_TOL * np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_reference_oracle(case):
    """Port plain version == reference jnp oracle (ragged n = 1001)."""
    x, kw = _inputs(case)
    want = jref.fused_step_ref(*_args(x, jnp.asarray), **kw)
    got = ref.fused_step_ref(*_args(x, torch.from_numpy), **kw)
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            _assert_close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ops_matches_reference_pallas_kernel(case):
    """The port's wrapper on CPU tensors (in place) == the reference's Pallas
    kernel in interpret mode, at n = 3·128 + 1 (a partial tail block)."""
    x, kw = _inputs(case, M=2, n=385, seed=1)
    want = jops.fused_local_step(*_args(x, jnp.asarray), **kw)
    # copies: jnp.asarray may alias the numpy buffers, JAX runs
    # asynchronously, and the port's step writes its inputs in place
    args = _args(x, lambda a: torch.from_numpy(a.copy()))
    got = ops.fused_local_step(*args, **kw)
    assert got[0] is args[0] and got[1] is args[1]     # updated in place
    if kw["update_d"]:
        assert got[2] is args[3]
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            _assert_close(g.numpy(), np.asarray(w))


def test_cpu_path_does_not_count_launches():
    x, kw = _inputs(CASES[3])
    before = su.fused_step_flat.launches
    ops.fused_local_step(*_args(x, torch.from_numpy), **kw)
    assert su.fused_step_flat.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never computes on the CPU."""
    x, kw = _inputs(CASES[2])
    with pytest.raises(ValueError, match="CUDA"):
        su.fused_step_flat(*_args(x, torch.from_numpy), **kw)


@pytest.mark.parametrize("bad,match", [
    (dict(g=np.zeros((3, 7), np.float32)), "g must be"),
    (dict(p=np.zeros((3, 1001), np.float64)), "float32"),
    (dict(t=None), "needs per-client t"),
    (dict(d=np.ones(1001, np.float32)), "update_d needs"),
])
def test_wrapper_rejects_bad_arguments(bad, match):
    x, kw = _inputs(CASES[3])
    for k, v in bad.items():
        if v is None:
            x.pop(k)
        else:
            x[k] = v
    with pytest.raises(ValueError, match=match):
        ops.fused_local_step(*_args(x, torch.from_numpy), **kw)


def test_wrapper_rejects_non_contiguous():
    x, kw = _inputs(CASES[2])
    args = _args(x, torch.from_numpy)
    args[0] = torch.from_numpy(np.asfortranarray(x["p"]))
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_local_step(*args, **kw)
