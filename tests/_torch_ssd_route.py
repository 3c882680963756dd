"""The card's SSD route on the CPU, for the model and serving tests.

``models.ssm.ssd_chunked`` takes K7 (and K7b under grad) on CUDA tensors
and ``_ssd_chunked`` elsewhere, from its inputs alone. ``k7_route`` puts a
spy on the route's intra-chunk term (``ssd_scan.intra_chunk``) with the
kernels' plain versions (``ref.ssd_intra_chunk_ref`` forward,
``ref.ssd_intra_chunk_vjp_ref`` backward) in their place, and with
``force`` stubs ``ssm._takes_k7`` true, so a CPU call runs the route's
composition (``ssd_scan.ssd_kernel_forward``) as the card does; without it
the route's own choice stands (the plain scan on the CPU)."""
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan
from repro_torch.models import ssm

_INTRA = ssd_scan.intra_chunk     # the route's own, before any spy
_TAKES = ssm._takes_k7            # and its own choice, before any stub


def k7_route(monkeypatch, force=True):
    """Returns the list of the chunk sizes of the route's calls, one entry
    a composition call (a forward or a remat recompute)."""
    calls = []

    def intra(xh, dt, A, Bm, Cm, chunk):
        calls.append(chunk)
        return _INTRA(xh, dt, A, Bm, Cm, chunk, fwd=ref.ssd_intra_chunk_ref,
                      vjp=ref.ssd_intra_chunk_vjp_ref)

    monkeypatch.setattr(ssd_scan, "intra_chunk", intra)
    monkeypatch.setattr(ssm, "_takes_k7", (lambda xh: True) if force
                        else _TAKES)
    return calls
