"""K7b, the hand-written VJP of the SSD intra-chunk kernel K7, on the CPU:
its plain version (``ref.ssd_intra_chunk_vjp_ref``) against autograd of
K7's plain version, the ``autograd.Function`` around K7
(``ssd_scan.intra_chunk``) under ``gradcheck`` with the plain versions in
the kernels' place, the whole kernel-route SSD's gradients against autograd
of ``_ssd_chunked``, the route's choice (``models.ssm._takes_k7``), and
K7b's count of work and launch plan. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).

Tolerances. In fp64 the plain VJP and autograd compute the same sums in
other orders: 1e-12 of each output's largest magnitude. In fp32 each output
is held to eps·M, eps = u·(4·max|cum| + 2(N + Q + P + H) + 16), u = 2^-24,
M the VJP on magnitudes (``magnitudes=True``): the form of
``tests/test_torch_cuda.py::k7b_bounds``, where both sides here sum over
all H heads (the kernel sums a split of heads in one chain).
"""
import functools

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm
from repro_torch.utils import trace

U = 2.0 ** -24

# (B, S, H, P, N, Q, G): Q dividing S and Q = S, one group (stride-0 B/C
# over the heads) and per-head B/C, ragged P, N and Q, a group of 2 heads
CASES = [(2, 32, 4, 8, 6, 8, 1), (2, 32, 4, 8, 6, 8, 4),
         (1, 16, 3, 5, 7, 16, 1), (1, 16, 3, 5, 7, 16, 3),
         (2, 24, 4, 8, 6, 12, 2), (1, 20, 2, 3, 4, 20, 1)]


def _inputs(B, S, H, P, N, G, dtype, seed=0, a=None):
    gen = torch.Generator().manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen, dtype=dtype)
    x = f(B, S, H, P)
    dt = torch.nn.functional.softplus(f(B, S, H))
    A = torch.full((H,), a, dtype=dtype) if a is not None else -torch.exp(f(H))
    return x, dt, A, f(B, S, G, N), f(B, S, G, N)


def _cotangents(B, S, H, P, N, Q, dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen, dtype=dtype)
    nc = S // Q
    return f(B, S, H, P), f(B, nc, H, N, P), f(B, nc, H)


def _autograd_vjp(x, dt, A, Bg, Cg, Q, cots):
    H = x.shape[2]
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bg, Cg)]
    out = ref.ssd_intra_chunk_ref(ins[0], ins[1], ins[2],
                                  ssm.broadcast_heads(ins[3], H),
                                  ssm.broadcast_heads(ins[4], H), Q)
    return torch.autograd.grad(out, ins, cots)


@pytest.mark.parametrize("B,S,H,P,N,Q,G", CASES)
def test_plain_vjp_matches_autograd_fp64(B, S, H, P, N, Q, G):
    x, dt, A, Bg, Cg = _inputs(B, S, H, P, N, G, torch.float64)
    cots = _cotangents(B, S, H, P, N, Q, torch.float64)
    want = _autograd_vjp(x, dt, A, Bg, Cg, Q, cots)
    got = ref.ssd_intra_chunk_vjp_ref(x, dt, A, Bg, Cg, Q, *cots)
    for name, w, g in zip(("dx", "ddt", "dA", "dB", "dC"), want, got):
        assert g.shape == w.shape and g.dtype == torch.float64, name
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max()), \
            name


@pytest.mark.parametrize("B,S,H,P,N,Q,G", CASES[:3])
@pytest.mark.parametrize("a", [None, -16.0])
def test_plain_vjp_matches_autograd_fp32(B, S, H, P, N, Q, G, a):
    """In fp32 at A = -16 too (max|cum| in the hundreds), element by
    element to the rounding bound of the module docstring."""
    x, dt, A, Bg, Cg = _inputs(B, S, H, P, N, G, torch.float32, a=a)
    cots = _cotangents(B, S, H, P, N, Q, torch.float32)
    want = _autograd_vjp(x, dt, A, Bg, Cg, Q, cots)
    got = ref.ssd_intra_chunk_vjp_ref(x, dt, A, Bg, Cg, Q, *cots)
    mags = ref.ssd_intra_chunk_vjp_ref(x, dt, A, Bg, Cg, Q, *cots,
                                       magnitudes=True)
    cmax = float((dt * A.abs()).reshape(B, S // Q, Q, H).sum(2).max())
    eps = U * (4 * cmax + 2 * (N + Q + P + H) + 16)
    for name, w, g, m in zip(("dx", "ddt", "dA", "dB", "dC"), want, got,
                             mags):
        assert g.dtype == torch.float32
        assert bool(((g - w).abs() <= eps * m).all()), name


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("Q", [4, 8])
def test_function_gradcheck(G, Q):
    """``intra_chunk`` in fp64 with the plain forward and the plain VJP in
    K7's and K7b's place: its backward is the derivative of its forward."""
    B, S, H, P, N = 1, 8, 3, 3, 4
    ins = [t.requires_grad_() for t in _inputs(B, S, H, P, N, G,
                                               torch.float64)]
    fn = lambda *t: ssd.intra_chunk(*t, Q, fwd=ref.ssd_intra_chunk_ref,
                                    vjp=ref.ssd_intra_chunk_vjp_ref)
    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-8,
                                     rtol=1e-6)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("with_h0", [False, True])
def test_kernel_route_grads_match_chunked(G, with_h0):
    """The route's composition (``ssd_kernel_forward`` over ``intra_chunk``,
    the plain versions in the kernels' place) against autograd of
    ``_ssd_chunked``, both fp32 throughout: y, the final state and every
    input's gradient, each to 1e-5 of its largest magnitude; G = 2 goes
    through the route's broadcast to per-head B/C."""
    B, S, H, P, N, Q = 2, 24, 4, 5, 6, 8
    ins = _inputs(B, S, H, P, N, G, torch.float32, seed=3)
    gen = torch.Generator().manual_seed(4)
    h0 = torch.randn((B, H, P, N), generator=gen) if with_h0 else None
    gy = torch.randn((B, S, H, P), generator=gen)
    gh = torch.randn((B, H, P, N), generator=gen)
    intra = functools.partial(ssd.intra_chunk, fwd=ref.ssd_intra_chunk_ref,
                              vjp=ref.ssd_intra_chunk_vjp_ref)

    def run(kernel_route):
        t = [v.clone().requires_grad_() for v in ins]
        h = None if h0 is None else h0.clone().requires_grad_()
        x, dt, A, Bg, Cg = t
        if kernel_route:
            if G not in (1, H):
                Bg, Cg = ssm.broadcast_heads(Bg, H), ssm.broadcast_heads(Cg, H)
            y, hf = ssd.ssd_kernel_forward(x, dt, A, Bg, Cg, Q, h,
                                           intra=intra)
        else:
            y, hf = ssm._ssd_chunked(x, dt, A, ssm.broadcast_heads(Bg, H),
                                     ssm.broadcast_heads(Cg, H), Q, h)
        leaves = t + ([h] if h is not None else [])
        return (y, hf) + torch.autograd.grad((y, hf), leaves, (gy, gh))

    for w, g in zip(run(False), run(True)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_cpu_call_runs_chunked(monkeypatch):
    """On the CPU a differentiated ``ssd_chunked`` call runs
    ``_ssd_chunked`` (never the kernel route) and ``model.ssd_k7`` stays
    0; a grouped B/C reaches it broadcast to the heads."""
    B, S, H, P, N, Q = 1, 16, 4, 4, 6, 8
    ins = [t.requires_grad_() for t in _inputs(B, S, H, P, N, 1,
                                               torch.float32)]
    seen = []
    real = ssm._ssd_chunked

    def spy(xh, dt, A, Bm, Cm, chunk, h0):
        seen.append((tuple(Bm.shape), Bm.stride()[2]))
        return real(xh, dt, A, Bm, Cm, chunk, h0)

    monkeypatch.setattr(ssm, "_ssd_chunked", spy)
    monkeypatch.setattr(ssd, "ssd_kernel_forward", None)
    assert not ssm._takes_k7(ins[0])
    with trace.recording() as rec:
        y, _ = ssm.ssd_chunked(*ins, Q)
        y.sum().backward()
    _, counters = rec.collect()
    assert seen == [((B, S, H, N), 0)]
    assert all(c.get("model.ssd_k7", 0) == 0 for c in counters.values())
    assert ins[3].grad.shape == (B, S, 1, N)


def test_route_needs_grad_fp32_and_limits(monkeypatch):
    """``_takes_k7`` is True for CUDA tensors with grad or without (a
    stand-in device test here), False on the CPU and for fake tensors. A
    routed call is held to K7's own contract (``ssd_scan.check_args``):
    fp32 inputs, Q <= 256 dividing S, N and P <= 128; past it ``ssd_chunked``
    raises rather than fall back to the plain scan, and so does a routed
    call that reaches the kernel on the CPU."""
    B, S, H, P, N, Q = 1, 16, 2, 4, 6, 8
    ins = [t.requires_grad_() for t in _inputs(B, S, H, P, N, 1,
                                               torch.float32)]

    class Cuda(torch.Tensor):
        is_cuda = True

    x = ins[0].as_subclass(Cuda)
    assert ssm._takes_k7(x) and ssm._takes_k7(x.detach())
    with torch.no_grad():
        assert ssm._takes_k7(x)
    assert not ssm._takes_k7(ins[0]) and not ssm._takes_k7(ins[0].detach())
    with FakeTensorMode():      # the dry run's fake CUDA tensors
        fake = torch.empty((B, S, H, P), device="cuda", requires_grad=True)
        assert fake.is_cuda
        assert not ssm._takes_k7(fake)

    monkeypatch.setattr(ssm, "_takes_k7", lambda xh: True)
    wide = torch.zeros((B, S, 1, ssd.NMAX + 1), requires_grad=True)
    for args, chunk, msg in (
            (ins, 6, "dividing S; got Q=6"),                 # S % Q != 0
            (ins, 512, "dividing S; got Q=512"),             # Q > 256
            ((*ins[:3], wide, wide), Q, "N=129"),
            ((torch.zeros((B, S, H, ssd.PMAX + 1)), *ins[1:]), Q, "P=129"),
            ((ins[0].double(), *ins[1:]), Q, "float32")):
        with pytest.raises(ValueError, match=msg):
            ssm.ssd_chunked(*args, chunk)
    with pytest.raises(ValueError, match="launches on CUDA"):
        ssm.ssd_chunked(*ins, Q)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba2_forward_hands_the_ssd_fp32_heads(monkeypatch, dtype):
    """Under any compute dtype ``mamba2_forward`` hands ``ssd_chunked`` fp32
    x heads and fp32 B/C groups (the card's route then takes K7 under
    ``--dtype bfloat16`` too), and the CPU's result and gradients are those
    of the compute-dtype heads to the bit (``_ssd_chunked`` casts them to
    fp32 first)."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-1.3b", reduced=True)
    gen = torch.Generator().manual_seed(2)
    p = ssm.init_mamba2(gen, cfg)
    u = torch.randn((2, 2 * cfg.ssm.chunk, cfg.d_model), generator=gen)
    seen = []
    real = ssm.ssd_chunked

    def spy(xh, dt, A, Bm, Cm, chunk, h0=None):
        seen.append((xh.dtype, Bm.dtype, Cm.dtype))
        return real(xh, dt, A, Bm, Cm, chunk, h0)

    def run():
        leaves = {k: p[k].clone().requires_grad_()
                  for k in ("conv_x", "A_log")}
        out = ssm.mamba2_forward({**p, **leaves}, cfg, u, dtype)
        return out, torch.autograd.grad(out.float().square().sum(),
                                        list(leaves.values()))

    monkeypatch.setattr(ssm, "ssd_chunked", spy)
    out, g = run()
    assert seen == [(torch.float32,) * 3]

    def heads_in_dtype(xh, dt, A, Bm, Cm, chunk, h0=None):
        return real(xh.to(dtype), dt, A, Bm, Cm, chunk, h0)

    monkeypatch.setattr(ssm, "ssd_chunked", heads_in_dtype)
    out2, g2 = run()
    assert out.dtype == dtype and torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(g, g2))


CELL2 = (2, 2048, 64, 64, 128, 256)      # mamba2-1.3b's training call


def test_work_bwd_at_the_training_shape():
    """17.6 GFLOP on the causal pairs, 0.263 ms at 67 TFLOP/s; per head
    the count is the four (Q, P)-by-(Q or N) products, per group three."""
    f, b = ssd.work_bwd(*CELL2, 1)
    B, S, H, P, N, Q = CELL2
    cells, pairs = B * (S // Q) * H, Q * (Q + 1) // 2
    assert f == cells * (4 * pairs * P + 4 * Q * N * P) \
        + B * (S // Q) * 6 * pairs * N == 17_617_649_664
    assert f / 67e12 * 1e3 == pytest.approx(0.26295, abs=5e-6)
    assert b == 4 * (3 * B * S * H * P + 2 * B * S * H + 2 * H
                     + 4 * B * S * N + cells * N * P + cells)
    assert ssd.work_bwd(*CELL2, 64)[0] > f


@pytest.mark.parametrize("shape,groups,nsplit", [
    (CELL2, 1, 8), (CELL2, 64, 1), ((1, 144, 3, 30, 20, 48), 1, 1),
    ((2, 512, 80, 64, 64, 256), 1, 10), ((2, 512, 80, 64, 64, 256), 80, 1),
])
def test_bwd_plan(shape, groups, nsplit):
    """The grids and scratch of K7b's four launches (the C launcher checks
    the grids against its own geometry)."""
    B, S, H, P, N, Q = shape
    p = ssd.plan_bwd(B, S, H, P, N, Q, groups)
    nc, nrt, nnt = S // Q, -(-Q // 64), -(-N // 64)
    bcg = B * nc * groups
    assert p.nsplit == nsplit and p.npairs == nrt * (nrt + 1) // 2
    assert p.grids == (bcg * p.npairs + bcg * nrt + -(-B * nc * H // 8),
                       bcg * p.npairs * nsplit + bcg * nrt * nnt * nsplit,
                       B * nc * H * nrt, H + bcg * nrt * nnt * 2)
    sh = p.scratch_shapes
    assert sh["dgp"] == (bcg, p.npairs, nsplit, 64, 64)
    assert sh["dbu"] == (bcg, nsplit, Q, N)
    assert sh["rsp"] == (B * nc * H, p.npairs, 64)


def test_bwd_args_checked_before_any_launch():
    """K7b's contract on the CPU: B/C groups 1 or H, cotangents of K7's
    output shapes; a CPU call raises after the checks."""
    B, S, H, P, N, Q = 1, 16, 4, 4, 6, 8
    x, dt, A, Bg, Cg = _inputs(B, S, H, P, N, 1, torch.float32)
    cots = _cotangents(B, S, H, P, N, Q, torch.float32)
    with pytest.raises(ValueError, match="launches on CUDA"):
        ssd.ssd_intra_chunk_bwd(x, dt, A, Bg, Cg, Q, *cots)
    two = torch.zeros((B, S, 2, N))
    with pytest.raises(ValueError, match="1 or H"):
        ssd.ssd_intra_chunk_bwd(x, dt, A, two, two, Q, *cots)
    with pytest.raises(ValueError, match="dS must be"):
        ssd.ssd_intra_chunk_bwd(x, dt, A, Bg, Cg, Q, cots[0],
                                cots[1][..., :-1], cots[2])
