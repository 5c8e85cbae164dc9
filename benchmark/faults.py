"""Faults planted in the program under a run, to show that the check
catches each fault a training cell can have (benchmark/tests and
control.py; the benchmark's own runs plant none):

* "unchanged": every step returns its state unchanged (kernel 1, which
  applies every table update of both cells, does nothing);
* "half_batch": each step leaves out the second half of its batch (its
  mask zeroed there), so its loss is the mean over the rest;
* "token": the sampler alters one id of each batch where it makes it;
* "own_draws": each step draws other negatives than its generator's
  stream gives at that point (it takes one draw of its own first), so
  the replayed draws that the reference follows are not the step's.

The cells run on one chip, so the exchange between chips has no fault to
plant.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from benchmark import trace

FAULTS = ("unchanged", "half_batch", "token", "own_draws")
# the step factory and the sampler class of each application's cell
STEP_FACTORY = {"graph": "make_graph_banded_fused_step",
                "knowledge_graph": "make_kg_pool_step"}
SAMPLER = {"graph": "DeviceWalkSampler",
           "knowledge_graph": "DeviceEdgeSampler"}


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged():
    def scatter_add_(table, ids, upd):
        return table

    return trace.scatter_replaced(scatter_add_)


def _half_batch(application):
    from graphvite_tpu_torch.ops import steps

    make = getattr(steps, STEP_FACTORY[application])

    @functools.wraps(make)
    def make_faulty(*args, **kwargs):
        step = make(*args, **kwargs)

        @functools.wraps(step)
        def faulty(state, *rest, mask=None, **kw):
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0
            return step(state, *rest, mask=mask, **kw)
        return faulty

    return _patched(steps, STEP_FACTORY[application], make_faulty)


def _own_draws(application):
    from graphvite_tpu_torch.ops import steps

    make = getattr(steps, STEP_FACTORY[application])

    @functools.wraps(make)
    def make_faulty(*args, **kwargs):
        step = make(*args, **kwargs)

        @functools.wraps(step)
        def faulty(state, *rest, generator=None, **kw):
            torch.rand(1, generator=generator, device=generator.device)
            return step(state, *rest, generator=generator, **kw)
        return faulty

    return _patched(steps, STEP_FACTORY[application], make_faulty)


def _token(application):
    from graphvite_tpu_torch.ops import device_sampler

    cls = getattr(device_sampler, SAMPLER[application])
    make = cls.make_sample_fn
    # the altered id: a walk's sixth vertex, or a triplet's tail
    at = {"graph": (0, (0, 5)), "knowledge_graph": (1, (0,))}[application]

    def make_sample_fn(self, batch_size):
        sample = make(self, batch_size)

        def altered(*arrays, **kw):
            out = sample(*arrays, **kw)
            ids = out[at[0]]
            # the next id down (up from 0): another vertex, in range
            ids[at[1]] = torch.where(ids[at[1]] > 0, ids[at[1]] - 1,
                                     ids[at[1]] + 1)
            return out
        return altered

    return _patched(cls, "make_sample_fn", make_sample_fn)


def planted(fault, application):
    """A context in which `fault` is planted in the program."""
    if fault == "unchanged":
        return _unchanged()
    if fault == "half_batch":
        return _half_batch(application)
    if fault == "token":
        return _token(application)
    if fault == "own_draws":
        return _own_draws(application)
    raise ValueError("no fault %r" % fault)
