"""Batched serving on the PyTorch port: prefill-cache reuse + greedy decode
on any arch (the port's counterpart of ``examples/serve_batched.py``).

  PYTHONPATH=src python examples/serve_batched_torch.py --arch zamba2-2.7b
  PYTHONPATH=src python examples/serve_batched_torch.py --arch qwen3-4b \
      --decode-window 16     # sliding-window decode (long_500k-style cache)
  PYTHONPATH=src python examples/serve_batched_torch.py --arch qwen2-0.5b \
      --no-greedy --seed 3   # categorical sampling (Gumbel-max)
  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

Serves the REDUCED config by default (``--full`` for the paper config),
on the card unless ``--device cpu`` is given.
"""
import argparse

from repro_torch.launch.serve import serve


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--full", action="store_true",
                    help="serve the full (paper-scale) config instead of "
                         "reduced")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--decode-window", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-greedy", action="store_true",
                    help="sample categorically instead of greedy argmax")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None, **serve_kw):
    """Serve once and print the first sequence's ids and the timings;
    returns the ``ServeResult``. ``serve_kw`` go to ``serve`` (a prompt or
    weights of the caller's)."""
    args = parser().parse_args(argv)
    res = serve(args.arch, reduced=not args.full, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                decode_window=args.decode_window, seed=args.seed,
                greedy=not args.no_greedy, device=args.device, verbose=False,
                **serve_kw)
    print("generated token ids (first sequence):", res.tokens[0].tolist())
    print("timings:", {k: round(v, 4) for k, v in res.timings.items()})
    return res


if __name__ == "__main__":
    main()
