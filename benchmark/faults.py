"""Faults planted in the program under a run, to show that the check
catches each fault a training cell can have (benchmark/tests and
control.py; the benchmark's own runs plant none):

* "unchanged": every step returns its state unchanged (the table-update
  entry that applies the cell's table updates does nothing);
* "half_batch": each step leaves out the second half of its batch (its
  mask zeroed there), so its loss is the mean over the rest;
* "token": the sampler alters one id of each batch where it makes it;
* "own_draws": each step draws other negatives than its generator's
  stream gives at that point (it takes one draw of its own first), so
  the replayed draws that the reference follows are not the step's.

Where each is planted is the job's answer (`TrainingJob.fault_points`,
apps/__init__.py), made from its configuration: the step factory, the
sampler class with the id it alters, and the table-update entry. A job
whose cells can have another fault (on several cards, the exchange
between them left out) lists it in its `FAULTS` and plants it itself
(`TrainingJob.plant`).
"""
from __future__ import annotations

import functools
import importlib

import torch

from benchmark import trace


def _unchanged(point):
    def update(table, *args, **kwargs):
        return table

    return trace.replaced(point, update)


def _step_wrapped(point, fault):
    """Every step that the factory at `point` makes from now on, called
    through `fault(step, state, *rest, **kw)`."""
    module, name = point
    make = getattr(importlib.import_module(module), name)

    @functools.wraps(make)
    def make_faulty(*args, **kwargs):
        step = make(*args, **kwargs)

        @functools.wraps(step)
        def faulty(state, *rest, **kw):
            return fault(step, state, *rest, **kw)
        return faulty

    return trace.replaced(point, make_faulty)


def _half_batch(step, state, *rest, mask=None, **kw):
    mask = mask.clone()
    mask[mask.shape[0] // 2:] = 0
    return step(state, *rest, mask=mask, **kw)


def _own_draws(step, state, *rest, generator=None, **kw):
    torch.rand(1, generator=generator, device=generator.device)
    return step(state, *rest, generator=generator, **kw)


def _token(point, at):
    """The sampler class at `point` alters id `at` = (output, index) of
    each batch it makes."""
    module, name = point
    cls = getattr(importlib.import_module(module), name)
    make = cls.make_sample_fn
    out_i, index = at[0], tuple(at[1])

    def make_sample_fn(self, batch_size):
        sample = make(self, batch_size)

        def altered(*arrays, **kw):
            out = sample(*arrays, **kw)
            ids = out[out_i]
            # the next id down (up from 0): another vertex, in range
            ids[index] = torch.where(ids[index] > 0, ids[index] - 1,
                                     ids[index] + 1)
            return out
        return altered

    return trace.swapped([cls], "make_sample_fn", make_sample_fn)


def planted(fault, job):
    """A context in which `fault` is planted in the program of `job` (a
    TrainingJob), where its `fault_points()` say."""
    points = job.fault_points()
    if fault == "unchanged":
        return _unchanged(points["update"])
    if fault == "half_batch":
        return _step_wrapped(points["step"], _half_batch)
    if fault == "token":
        return _token(points["sampler"], points["token"])
    if fault == "own_draws":
        return _step_wrapped(points["step"], _own_draws)
    return job.plant(fault)
