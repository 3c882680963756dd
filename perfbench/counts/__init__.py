"""Model FLOPs and kernel bytes, counted from shapes by the benchmark's own
functions: one module a model family (``dense``, ``ssm``: the FLOPs of one
gradient a token) and one a method (``savic``: the round's FLOPs and the
local step's bytes). They count the work of the mathematics, not what an
implementation dispatches: recompute is not counted, a causal product
counts the keys at or before each query, the vocabulary is the real one.
"""
import importlib


def family(name: str):
    """The counting module of a model family (``counts/<family>.py``)."""
    return importlib.import_module(f"perfbench.counts.{name}")
