"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The module imports only the port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q

K1 (``fused_step_flat``) and K3 (``quantize_update_flat``) are held bitwise:
kernel and plain version run the same fp32 operations in the same order, and
the kernels are built without FMA contraction (K3's int8 q exactly).
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize_update as qu
from repro_torch.kernels import scaled_update as su

# (kind, schedule, clip, d, update_d, wd, h, s)
CASES = [
    ("identity", "const", "max", None, False, 0.0, False, False),
    ("identity", "const", "max", None, False, 0.01, False, True),
    ("adam", "debias", "max", "global", False, 0.0, False, False),
    ("adam", "debias", "add", "local", True, 0.01, False, True),
    ("adam", "const", "max", "local", True, 0.0, True, False),
    ("rmsprop", "const", "max", "local", True, 0.0, False, True),
    ("rmsprop", "debias", "add", "global", False, 0.01, False, False),
    ("adagrad", "const", "max", "local", True, 0.01, True, True),
    ("adagrad", "const", "add", "global", False, 0.0, False, True),
    ("oasis", "debias", "add", "local", True, 0.01, True, True),
]
IDS = ["-".join(str(v) for v in c) for c in CASES]
ORDER = ("p", "m", "g", "d", "h", "t", "s")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(case, M, n, dev, seed=0):
    kind, schedule, clip, dmode, update_d, wd, has_h, has_s = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = {"p": f(M, n), "m": f(M, n), "g": f(M, n), "d": None, "h": None,
         "t": torch.randint(0, 50, (M,), generator=gen, device=dev,
                            dtype=torch.int32), "s": None}
    if dmode == "local":
        x["d"] = f(M, n) if kind == "oasis" else f(M, n).abs_()
    elif dmode == "global":
        x["d"] = f(n).abs_()
    if has_h:
        x["h"] = f(M, n) if kind == "oasis" else f(M, n).square_()
    if has_s:
        x["s"] = torch.rand((M,), generator=gen, device=dev) * 0.9 + 0.1
    kw = dict(gamma=0.05, beta1=0.9, weight_decay=wd, alpha=1e-2,
              beta2=0.99, kind=kind, clip=clip, schedule=schedule,
              update_d=update_d)
    return x, kw


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4097, 4095, 4096 * 3 + 4])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k1_bitwise_vs_plain(dev, case, n):
    """Ragged n: 4·1024 and 3·4096 + 4 (float4 path), ±1 (scalar path with
    a masked tail)."""
    x, kw = _inputs(case, 3, n, dev)
    want = ref.fused_step_ref(*(x[k] for k in ORDER), **kw)
    before = su.fused_step_flat.launches
    got = ops.fused_local_step(*(x[k] for k in ORDER), **kw)
    torch.cuda.synchronize()
    assert su.fused_step_flat.launches == before + 1
    assert got[0] is x["p"] and got[1] is x["m"]        # written in place
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.cuda
def test_k1_scalar_path_on_misaligned_views(dev):
    """Rows of a buffer viewed at an odd offset are not 16-byte aligned: the
    wrapper must take the scalar path and still match bitwise."""
    x, kw = _inputs(CASES[3], 2, 4096, dev)
    for k in ("p", "m", "g", "d"):
        buf = torch.empty(x[k].numel() + 1, device=dev)
        buf[1:] = x[k].reshape(-1)
        x[k] = buf[1:].view(x[k].shape)
    want = ref.fused_step_ref(*(x[k] for k in ORDER), **kw)
    got = su.fused_step_flat(*(x[k] for k in ORDER), **kw)
    for w, g in zip(want, got):
        if w is not None:
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_k1_rejects_cpu_and_mixed_devices(dev):
    x, kw = _inputs(CASES[2], 2, 64, dev)
    x["g"] = x["g"].cpu()
    with pytest.raises(ValueError, match="g is on"):
        su.fused_step_flat(*(x[k] for k in ORDER), **kw)


def _qdq_inputs(M, n, dev, zero_rows=(), seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, n), generator=gen, device=dev) \
        * torch.rand((M, 1), generator=gen, device=dev) * 10
    x[list(zero_rows)] = 0.0
    u = torch.rand((M, n), generator=gen, device=dev)
    return x, u, x.abs().amax(dim=1) / 127.0


@pytest.mark.cuda
@pytest.mark.parametrize("M,n,zero_rows", [
    (1, 4096, ()), (4, 4097, (1,)), (4, 4095, (0, 3)), (3, 4096 * 3 + 4, (2,)),
])
def test_k3_bitwise_vs_plain(dev, M, n, zero_rows):
    """Ragged n (float4 path and scalar path with a masked tail), rows with a
    zero scale: q equal, dec bitwise."""
    x, u, s = _qdq_inputs(M, n, dev, zero_rows)
    wq, wdec = ref.quantize_update_ref(x, u, s)
    before = qu.quantize_update_flat.launches
    q, dec = ops.quantize_update(x, u, s)
    torch.cuda.synchronize()
    assert qu.quantize_update_flat.launches == before + 1
    assert torch.equal(q, wq)
    assert torch.equal(dec.view(torch.int32), wdec.view(torch.int32))


@pytest.mark.cuda
def test_k3_scalar_path_on_misaligned_views(dev):
    x, u, s = _qdq_inputs(2, 4096, dev)
    views = []
    for t in (x, u):
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:] = t.reshape(-1)
        views.append(buf[1:].view(t.shape))
    wq, wdec = ref.quantize_update_ref(*views, s)
    q, dec = qu.quantize_update_flat(*views, s)
    assert torch.equal(q, wq)
    assert torch.equal(dec.view(torch.int32), wdec.view(torch.int32))


@pytest.mark.cuda
def test_k3_rejects_mixed_devices(dev):
    x, u, s = _qdq_inputs(2, 64, dev)
    with pytest.raises(ValueError, match="u is on"):
        qu.quantize_update_flat(x, u.cpu(), s)
