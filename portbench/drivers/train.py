"""Training traffic: prod training jobs back to back, one at a time.

Each job is ``train/trainer.train_lightgcn`` over the configuration's
graph (``save_artifacts=False``), as an operator runs it: its own set-up,
its epochs between boundaries as captured CUDA graphs (a job captures two
lengths: the first interval's, whose first epoch runs eagerly, and the
second's), an evaluation every ``epoch_per_eval`` epochs. The window opens
at the first job's evaluation record of epoch ``traffic["open_at"]``, once
both lengths are captured, and closes at the first boundary (an
evaluation record or a job's return) at or after ``seconds``.
``train_examples_per_s`` is the BPR triples of the epochs completed
between the window's first and last boundary over the time between them:
evaluations, job set-ups and captures that fall inside count as time.

What the check judges is what the program gives at its boundaries; the
benchmark reads it from the trainer's frames at each ``[Iteration e/E]``
record (read only: the record's loss, val loss and metrics, the tables
and Adam's state), and the tables a job returns:

- every job's start (the first in set-up, later ones in the window): the
  epoch-0 record's loss and first gradient (Adam's first moment over
  1 - beta1), the first interval's last loss and the tables' change over
  it;
- the window's judged intervals: its first, ``traffic["judged_drawn"]``
  more drawn from the seed among its first ``traffic["judged_among"]``,
  and each job's last (the second graph length again, up to the job's
  return): the state at the interval's first boundary, copied to the
  host, its last loss and the tables at its end;
- the evaluation row at the end of each judged interval that ends in one.

With ``trace`` a CUDA event is recorded behind each CUDA graph replay
(``torch.cuda.CUDAGraph.replay`` wrapped for the run), so that
``train.eval_share`` can tell an interval's replays from its evaluation.
"""
from __future__ import annotations

import logging
import re
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from portbench import judge, problem
from portbench.reference import evaluate as ref_eval
from portbench.reference import train as ref_train

RECORD = re.compile(r"\[Iteration (\d+)/(\d+)\]")


class WindowClosed(Exception):
    """Raised at the boundary that closes the window; stops the job."""


@dataclass
class Interval:
    """The span between two boundaries of the window."""

    start_ns: int
    end_ns: int
    epochs: int
    kind: str  # "eval" or "return" (the job returned) or "job_start" (its epoch-0 record)
    replay_end_ns: Optional[int] = None  # when its last graph replay finished on the device


@dataclass
class Span:
    """A judged interval of the program: epochs ``epoch0 .. epoch0 + n - 1``
    from ``start`` (host copies), and what it gave."""

    epoch0: int
    n: int
    start: ref_train.State
    readout: judge.SpanReadout
    end_tables: Optional[List[torch.Tensor]] = None


@dataclass
class Outcome:
    e2e: dict
    attempted: int
    failed: int
    records: dict
    starts: List[judge.StartReadout]
    spans: List[Span]
    config: dict
    rows: dict
    feats: tuple
    seed: int

    @property
    def readout(self) -> judge.TrainReadout:
        return judge.TrainReadout(self.starts, [s.readout for s in self.spans])


def _program_at_record():
    """(the record's locals, the trainer's locals) of the evaluation record
    being logged: ``_record_eval`` holds its loss, val loss and metrics,
    ``train_lightgcn`` the tables and the optimizer."""
    frame, record = sys._getframe(2), None
    while frame is not None:
        name = frame.f_code.co_name
        if name == "_record_eval" and record is None:
            record = frame.f_locals
        elif name == "train_lightgcn" and "lgcnhs_tpu_torch" in frame.f_code.co_filename:
            return record, frame.f_locals
        frame = frame.f_back
    raise RuntimeError("an evaluation record outside train_lightgcn")


def _host(tensors) -> List[torch.Tensor]:
    return [t.detach().to("cpu", copy=True) for t in tensors]


def _moment(opt, table: torch.Tensor, name: str) -> torch.Tensor:
    """Adam's moment of ``table``; zeros where it has none (no step taken)."""
    value = opt.state.get(table, {}).get(name)
    return torch.zeros_like(table) if value is None else value


def _state(trainer_locals) -> ref_train.State:
    params, opt = trainer_locals["params"], trainer_locals["optimizer"]
    tables = [params.user_emb, params.item_emb]
    return ref_train.State(_host(tables), _host(_moment(opt, t, "exp_avg") for t in tables),
                           _host(_moment(opt, t, "exp_avg_sq") for t in tables))


def _row(record) -> dict:
    p, r, n, h, i = (float(x) for x in record["metrics"])
    return dict(zip(judge.ROW, (float(record["vloss"]), p, r, 2 * p * r / (p + r) if p + r else 0.0,
                                n, h, i)))


class _Jobs(logging.Handler):
    """Follows the jobs through the trainer's records and returns: opens and
    closes the window, keeps its intervals and what the check judges."""

    def __init__(self, window, traffic: dict, config: dict, seed: int):
        super().__init__(logging.DEBUG)
        self.window, self.open_at = window, traffic["open_at"]
        self.epochs, self.per_eval = config["epochs"], config["epoch_per_eval"]
        self.last_eval = (self.epochs - 1) // self.per_eval * self.per_eval
        rng = np.random.default_rng([seed, 3])
        among = range(1, traffic["judged_among"])
        self.judged = {0} | {int(i) for i in rng.choice(among, traffic["judged_drawn"],
                                                         replace=False)}
        self.job = 0
        self.opened = False
        self.last_ns, self.last_epoch, self.last_job = 0, -1, 0
        self.intervals: List[Interval] = []
        self.starts: List[judge.StartReadout] = []
        self.spans: List[Span] = []
        self._job_start = None  # (epoch 0's loss, first gradient norms, tables after it)
        self._pending: Optional[Span] = None
        self._replays: list = []
        self._origin = None

    def emit(self, record: logging.LogRecord) -> None:
        if RECORD.search(record.getMessage()):
            rec, trainer = _program_at_record()
            self.boundary(int(rec["epoch"]), "eval", rec, trainer)

    def replayed(self) -> None:
        if self._origin is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._replays.append(ev)

    def job_returned(self, result) -> None:
        self.boundary(self.epochs - 1, "return", tables=[result.params.user_emb,
                                                         result.params.item_emb])

    def _observe(self, epoch: int, kind: str, rec, trainer, tables) -> None:
        if kind == "eval" and epoch == 0:
            opt, params = trainer["optimizer"], trainer["params"]
            beta1 = opt.param_groups[0]["betas"][0]
            pair = [params.user_emb, params.item_emb]
            grads = [float(_moment(opt, t, "exp_avg").norm()) / (1.0 - beta1) for t in pair]
            self._job_start = (float(rec["loss"]), grads, _host(pair))
        elif kind == "eval" and epoch == self.per_eval and self._job_start is not None:
            loss0, grads, before = self._job_start
            after = _host([trainer["params"].user_emb, trainer["params"].item_emb])
            self.starts.append(judge.StartReadout(loss0, grads, float(rec["loss"]),
                                                  ref_train.change_norms(before, after)))
            self._job_start = None
        span, self._pending = self._pending, None
        if span is not None and span.epoch0 + span.n - 1 == epoch:
            end = _host(tables if kind == "return" else
                        [trainer["params"].user_emb, trainer["params"].item_emb])
            span.end_tables = end
            span.readout = judge.SpanReadout(
                None if kind == "return" else float(rec["loss"]),
                ref_train.change_norms(span.start.tables, end),
                None if kind == "return" else _row(rec))
            self.spans.append(span)

    def _judge_next(self, epoch: int, trainer) -> None:
        """Keeps the state at this record where the interval it starts is judged."""
        if (len(self.intervals) in self.judged or epoch == self.last_eval) \
                and epoch < self.epochs - 1:
            n = min(epoch + self.per_eval, self.epochs - 1) - epoch
            self._pending = Span(epoch + 1, n, _state(trainer), None)

    def boundary(self, epoch: int, kind: str, rec=None, trainer=None, tables=None) -> None:
        ns = time.time_ns()
        self._observe(epoch, kind, rec, trainer, tables)
        if not self.opened:
            if self.job == 1 and kind == "eval" and epoch == self.open_at:
                self.window.open()
                self.opened = True
                if self.window.session is not None and self.window.device.type == "cuda":
                    self._origin = torch.cuda.Event(enable_timing=True)
                    self._origin.record()
                self.last_ns, self.last_job, self.last_epoch = self.window.ns_open, 1, epoch
                self._judge_next(epoch, trainer)
            return
        if kind == "return":
            n, label = self.epochs - 1 - self.last_epoch, "return"
        elif self.job != self.last_job:
            n, label = epoch + 1, "job_start"
        else:
            n, label = epoch - self.last_epoch, "eval"
        replay_end = None
        if self._replays:
            self._replays[-1].synchronize()
            replay_end = self.window.ns_open + int(
                self._origin.elapsed_time(self._replays[-1]) * 1e6)
        self.intervals.append(Interval(self.last_ns, ns, n, label, replay_end))
        self._replays = []
        self.last_ns, self.last_job = ns, self.job
        self.last_epoch = self.epochs - 1 if kind == "return" else epoch
        if self.window.expired():
            self.window.close()
            raise WindowClosed
        if kind == "eval":
            self._judge_next(epoch, trainer)


def run(config: dict, traffic: dict, seed: int, window, device) -> Outcome:
    from lgcnhs_tpu_torch.runtime.logging import get_logger
    from lgcnhs_tpu_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = problem.table(config, seed)
    cfg, graph = problem.program_graph(config, rows, seed,
                                       tempfile.gettempdir() + "/portbench-work")
    feats = problem.features(config, seed, graph.n_users, graph.n_items)
    jobs = _Jobs(window, traffic, config, seed)
    logger = get_logger()
    logger.addHandler(jobs)
    replay = torch.cuda.CUDAGraph.replay

    def replay_and_mark(graph_self):
        replay(graph_self)
        jobs.replayed()

    if window.traced and device.type == "cuda":
        torch.cuda.CUDAGraph.replay = replay_and_mark
    try:
        while True:
            jobs.job += 1
            try:
                result = trainer.train_lightgcn(graph, cfg, *feats, save_artifacts=False,
                                                device=device)
                jobs.job_returned(result)
            except WindowClosed:
                break
    finally:
        torch.cuda.CUDAGraph.replay = replay
        logger.removeHandler(jobs)
    epochs = sum(iv.epochs for iv in jobs.intervals)
    return Outcome(
        e2e={"train_examples_per_s": epochs * config["batch_size"] / window.elapsed},
        attempted=epochs, failed=0, records={"intervals": jobs.intervals},
        starts=jobs.starts, spans=jobs.spans, config=config, rows=rows, feats=feats, seed=seed)


def shapes(config: dict, split) -> dict:
    from portbench.reference.data import first_unique

    tu, _ = first_unique(split.train_users, split.train_items, split.n_items)
    return {"U": split.n_users, "I": split.n_items, "nnz": int(tu.shape[0]),
            "D": config["embedding_dim"], "L": config["layers"], "k": config["k"],
            "batch": config["batch_size"]}


class Reference:
    """The reference's side of a run's check, built once: the split, the
    train graph, the evaluation's data and the start from the seed."""

    def __init__(self, outcome: Outcome, device):
        self.outcome, self.device = outcome, device
        self.split = problem.reference_split(outcome.config, outcome.rows)
        self.graph = ref_train.train_graph(self.split, device)
        self.data = ref_eval.eval_data(self.split, device)
        self._rows = None

    def readouts(self, precision: str = "float32", half_batch: bool = False,
                 lr_decay: bool = True):
        """(start, spans) of the reference, or of a control (``precision``)
        or a fault (``half_batch``, ``lr_decay``) in the program's place:
        the start from the seed, each judged span from the program's state
        at its first boundary, each evaluation of the program's tables."""
        o, cfg = self.outcome, self.outcome.config
        kw = dict(precision=precision, half_batch=half_batch, lr_decay=lr_decay)
        s0 = ref_train.initial_state(*o.feats, cfg["embedding_dim"], o.seed, self.device)
        f0 = ref_train.follow(self.graph, s0, cfg, o.seed, 0, 1, **kw)
        fb = ref_train.follow(self.graph, f0.state, cfg, o.seed, 1, cfg["epoch_per_eval"], **kw)
        start = judge.StartReadout(f0.losses[0], f0.first_grad_norms, fb.losses[-1],
                                   ref_train.change_norms(f0.state.tables, fb.state.tables))
        rows = self.rows("fp8" if precision == "fp8" else "float64")
        spans = []
        for span, row in zip(o.spans, rows):
            f = ref_train.follow(self.graph, span.start.to(self.device), cfg, o.seed,
                                 span.epoch0, span.n, **kw)
            spans.append(judge.SpanReadout(
                None if span.readout.loss is None else f.losses[-1],
                ref_train.change_norms(span.start.tables, f.state.tables), row))
        return start, spans

    def rows(self, precision: str = "float64"):
        """The evaluation of the program's tables at each judged span's end."""
        if precision == "float64" and self._rows is not None:
            return self._rows
        o = self.outcome
        rows = [None if s.readout.row is None else
                ref_eval.evaluate(self.data, s.end_tables, o.config, o.seed,
                                  s.epoch0 + s.n - 1, precision) for s in o.spans]
        if precision == "float64":
            self._rows = rows
        return rows


def check(outcome: Outcome, device):
    """(numbers, shapes): what the program gave at its boundaries against
    the reference."""
    ref = Reference(outcome, device)
    numbers = judge.train_numbers(outcome.readout, *ref.readouts())
    return numbers, shapes(outcome.config, ref.split)
