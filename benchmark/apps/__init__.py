"""Jobs that drive the program's training entries, one module per application
(a configuration's "application" names it).

Each module defines `Job(cfg, traffic, seed, device)`, a `TrainingJob`:
set-up makes the inputs from the seed, builds the solver, installs the
initial tables that `benchmark.init` makes, and drives the solver's own
`train` through its first steps (`followed_steps` of the traffic file);
`call()` is one call of the window. Every step of every runner goes through the step that the
program built, called as the runner calls it (the step draws its own
negatives); the steps that set-up follows and the first step of each
window call are recorded, the draws replayed from a copy of the
generator's state taken before the step (`record_step`).
`check(dtype)` hands what was recorded to the configuration's plain
reference after the program is freed.

Two hooks say where the harness reaches into the program, each as
(module, attribute) pairs, so that a job on another route or engine
names its own: `recorded_runner()`, the runner factory whose steps are
recorded, and `fault_points()`, where faults.py plants each fault.
"""
from __future__ import annotations

import contextlib
import gc
import importlib

import numpy as np
import torch

from benchmark import init, trace
from benchmark.reference import common


class TrainingJob:
    """What the graph and knowledge-graph jobs share."""

    # the faults this job's cells can have (benchmark/tests plants each);
    # a job with one more (say, the exchange between cards left out) adds
    # its name here and plants it in `plant`
    FAULTS = ("unchanged", "half_batch", "token", "own_draws")

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.steps = []          # what `record_step` kept of each step
        self.calls = []          # (batch ids, num_batch) of each call
        self.readings = {}       # the program's numbers for the check
        self.window_step = None  # the last window call's first step
        self.tables_nonfinite = None
        self.solver = None
        self._record = 0         # steps still to record
        self._window = False     # recording a window call's step
        self._unwrap = None

    # -- hooks of an application -------------------------------------------
    def recorded_runner(self):
        """(module, attribute) of the program's runner factory whose steps
        are recorded: it takes the step as its first argument and calls
        it as step(state, *args, mask=..., generator=...)."""
        return ("graphvite_tpu_torch.ops.steps", "make_fused_runner")

    def fault_points(self):
        """Where faults.py plants each fault in this job's program, made
        from its configuration: {"step": (module, attribute) of the step
        factory whose steps half_batch and own_draws wrap, "sampler":
        (module, class) whose make_sample_fn the token fault wraps,
        "token": (output, index) of the id it alters in each batch,
        "update": (module, attribute) of the table-update entry that
        unchanged empties}."""
        raise NotImplementedError

    def plant(self, fault):
        """A context in which `fault`, a name of this job's FAULTS that
        faults.py does not plant itself, is planted in the program."""
        raise ValueError("no fault %r" % fault)

    def step_inputs(self, step, state, args, mask, replay):
        """What the reference needs of one step's inputs ({name: tensor},
        with its "lr"), the step's own draws made again from `replay`, a
        generator in the state the step's generator was in."""
        raise NotImplementedError

    def step_rows(self, state, rec):
        """Per table of the configuration, the float32 rows of `state`
        that the step of `rec` reads, at `rec`'s ids (with repeats)."""
        raise NotImplementedError

    def check_sampler(self, steps):
        """The reference's exact and statistical readings of the recorded
        samples: {name: number}."""
        raise NotImplementedError

    def follow(self, dtype):
        """The reference's readings of the followed steps in `dtype`."""
        raise NotImplementedError

    def follow_window(self, dtype):
        """The reference's readings of the recorded window step in
        `dtype`, from the program's rows before it."""
        raise NotImplementedError

    def samples_per_batch(self):
        raise NotImplementedError

    def check(self, dtype):
        """(gaps, sampler readings): the program's readings against the
        float32 reference's, or with `dtype` below float32 the
        reference's own in that precision (the control)."""
        checks = self.check_sampler(self.steps + [self.window_step])
        checks["first_batch_diff"] = self.first_batch_diff()
        checks["tables_nonfinite"] = self.tables_nonfinite
        ref = self.follow(torch.float32)
        checks["reference_grad_norms"] = ref["grad_norms"]
        got = self.readings if dtype == torch.float32 else self.follow(dtype)
        gaps = common.gaps(got, ref)
        ref = self.follow_window(torch.float32)
        got = (common.window_readings(self.window_step)
               if dtype == torch.float32 else self.follow_window(dtype))
        gaps.update(common.window_gaps(got, ref))
        return gaps, checks

    # -- shared mechanics --------------------------------------------------
    def install_init(self, solver):
        """The solver's tables are the benchmark's (benchmark.init), made
        where the solver would make its own: at the first train call."""
        dtype = solver.float_type

        def init_embeddings(*args, **kwargs):
            solver.state = None
            tables = init.make(self.cfg, self.seed, self.device, dtype)
            moments = tuple(solver.optimizer.init_moments(t.shape,
                                                          self.device)
                            for t in tables)
            solver.state = {"tables": tuple(tables), "moments": moments}

        solver.init_embeddings = init_embeddings

    def _train(self, batches, fresh=False):
        """One call of the solver's train entry that trains `batches` more
        batches, the linear schedule running to their end: from the
        initial tables (`fresh`), or resumed. A resumed call trains whole
        episodes (the solver runs min(episode_size, num_batch) batches a
        runner call), so it is one or more episodes long."""
        s = self.solver
        b0 = 0 if fresh else s.batch_id
        total = b0 + batches
        if total == 1:
            # the effective batch is planned inside train(); num_batch is
            # at least 1, so a call of one batch needs no plan
            num_epoch = 1e-12
        else:
            num_epoch = total * s.effective_batch / s.graph.num_edge + 1e-9
        s.train(resume=not fresh, num_epoch=num_epoch, **self.cfg["train"])
        if s.batch_id != total or s.num_batch != total:
            raise RuntimeError("train ran to batch %d of %d, not %d"
                               % (s.batch_id, s.num_batch, total))
        self.calls.append((list(range(b0, total)), total))

    def _wrap_runners(self):
        """Every runner that the factory `recorded_runner()` names makes
        from now on calls the program's step through `_step`, which passes
        the call on unchanged and records the steps that `_record`
        counts."""
        module, name = self.recorded_runner()
        make = getattr(importlib.import_module(module), name)

        def make_recorded(step_fn, *args, **kwargs):
            def step(state, *rest, mask=None, generator=None):
                if not self._record:
                    return step_fn(state, *rest, mask=mask,
                                   generator=generator)
                self._record -= 1
                return self.record_step(step_fn, state, rest, mask,
                                        generator)
            return make(step, *args, **kwargs)

        stack = contextlib.ExitStack()
        stack.enter_context(trace.replaced((module, name), make_recorded))
        self._unwrap = stack.close

    def record_step(self, step, state, args, mask, generator):
        """Run the program's `step` as the runner does, keeping its inputs
        (its draws made again from a copy of the generator's state) and,
        for a window step, the rows it reads before and after and its
        loss."""
        replay = torch.Generator(device=generator.device)
        replay.set_state(generator.get_state())
        rec = self.step_inputs(step, state, args, mask, replay)
        if self._window:
            rec["before"] = self.step_rows(state, rec)
        out = step(state, *args, mask=mask, generator=generator)
        if self._window:
            rec["after"] = self.step_rows(out[0], rec)
            rec["loss"] = out[1]
            self.window_step = rec
        else:
            self.steps.append(rec)
        return out

    def leaf_distances(self):
        """Per table: the distance of the program's table from its
        initial value."""
        return [float(np.sqrt(init.distance_sq(self.cfg, i, self.seed, t)))
                for i, t in enumerate(self.solver.state["tables"])]

    def set_up(self):
        """The first steps, followed by the reference. A call of one batch
        from the initial tables gives the state after one step; a second
        call from the initial tables trains `followed_steps` batches, the
        first of them the same batch again (the generator restarts with
        the call), and the window resumes from it. No warm-up call: these
        steps run every kernel at the window's shapes, and a window's
        first call runs as its later ones."""
        n = int(self.traffic["followed_steps"])
        self._wrap_runners()
        self._record = 1
        self._train(1, fresh=True)
        lr = self.steps[0]["lr"]
        self.readings["grad_norms"] = [d / lr for d in self.leaf_distances()]
        self._record = n
        self._train(n, fresh=True)
        self.readings["losses"] = (
            self.solver.batch_losses.double().cpu().tolist())
        self.readings["change_norms"] = self.leaf_distances()
        self.first, self.steps = self.steps[0], self.steps[1:]
        self.followed_call = self.calls[1]

    def first_batch_diff(self):
        """Entries in which the first step of the one-batch call and of the
        followed call differ (the state after one step is read from the
        first, so they must be the same batch)."""
        a, b = self.first, self.steps[0]
        return sum(int((a[k] != b[k]).sum()) for k in a
                   if torch.is_tensor(a[k]))

    def batches_per_call(self):
        return int(self.traffic["episodes_per_call"]) * int(
            self.cfg["build"]["episode_size"])

    def call(self, record=True):
        """One call of the window: whole episodes, its first step recorded
        (`record`). Returns its batches."""
        b = self.batches_per_call()
        self._record, self._window = int(record), True
        self._train(b)
        self._record = 0
        return b

    def release(self):
        """Count the non-finite entries of the program's tables, then free
        the program's state before the reference runs."""
        if self._unwrap is not None:
            self._unwrap()
        self.tables_nonfinite = sum(
            int((~torch.isfinite(t[r0:r0 + init.BLOCK_ROWS])).sum())
            for t in self.solver.state["tables"]
            for r0 in range(0, t.shape[0], init.BLOCK_ROWS))
        self.solver = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
