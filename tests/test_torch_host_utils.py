"""The port's ``utils/profiling.py`` and ``utils/log.py`` on the CPU.

``profile_trace`` is ``torch.profiler`` in place of JAX's
``jax.profiler``: on the CPU (asked for explicitly; the default is the
card) it writes a Chrome trace naming the profiled ops. ``get_logger``
takes its rank from the ``torch.distributed`` world: in a world of 2 over
gloo (``parallel.launch.run_world``) only rank 0 emits, or rank 1 prefixes
``[RANK 1]``; in one process its records read as JAX's logger's.
``SectionTimer`` and ``StepTimeMonitor`` are copies: the same records give
JAX's reports exactly.
"""

import io
import itertools
import json
import logging
import re
import sys
import time

import pytest
import torch

from chronoedit_tpu.utils import log as log_j
from chronoedit_tpu.utils import profiling as prof_j
from chronoedit_tpu_torch.parallel.launch import run_world
from chronoedit_tpu_torch.utils import log as log_t
from chronoedit_tpu_torch.utils import profiling as prof_t

import test_torch_log_workers as W


def test_profile_trace_on_the_cpu(tmp_path):
    """The trace names the ops run inside the block, and only those; two
    traces get two files; ``enabled=False`` writes nothing."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    torch.mm(a, b)  # outside: not in the trace
    with prof_t.profile_trace(str(tmp_path), device="cpu") as trace:
        torch.addmm(a, a, b).relu()
    events = json.load(open(trace.path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"aten::addmm", "aten::relu"} <= names and "aten::mm" not in names
    assert prof_t.kernel_names(trace.path) == []  # no device on the CPU
    assert any(e.key == "aten::addmm" for e in trace.profile.key_averages())
    with prof_t.profile_trace(str(tmp_path), device="cpu") as again:
        torch.sin(a)
    assert again.path != trace.path and len(list(tmp_path.iterdir())) == 2
    with prof_t.profile_trace(str(tmp_path / "off"), enabled=False) as off:
        torch.sin(a)
    assert off.path == "" and not (tmp_path / "off").exists()


def test_profile_trace_wants_the_card_by_default(tmp_path, monkeypatch):
    """Without ``device`` the work is taken to run on the card, which this
    machine lacks: the call raises instead of tracing the CPU alone. A
    trace of card work with no kernel event raises after it is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with prof_t.profile_trace(str(tmp_path)):
            pass

    class Prof:  # a profiler that records nothing, as on a card it never saw
        def __init__(self, activities):
            assert torch.profiler.ProfilerActivity.CUDA in activities

        start = stop = lambda self: None

        def export_chrome_trace(self, path):
            json.dump({"traceEvents": [{"name": "aten::mm", "cat": "cpu_op"}]}, open(path, "w"))

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    with pytest.raises(RuntimeError, match="no CUDA kernel event"):
        with prof_t.profile_trace(str(tmp_path / "card"), device="cuda:0"):
            pass
    assert len(list((tmp_path / "card").iterdir())) == 1


@pytest.mark.parametrize("rank0_only", [True, False])
def test_logger_in_a_world_of_two(tmp_path, rank0_only):
    out = run_world(W.log_world, 2, (f"ce_log_{rank0_only}", rank0_only), timeout=90.0,
                    tmp_dir=str(tmp_path))
    assert "hello from rank 0" in out[0] and "second line" in out[0]
    assert "[RANK" not in out[0]
    if rank0_only:
        assert out[1] == ""
    else:
        assert "[RANK 1] hello from rank 1" in out[1] and "[RANK 1] second line" in out[1]


def test_logger_reads_as_jax_in_one_process(tmp_path):
    """One process is rank 0 on both sides: the same lines, once each (a
    second call returns the same logger), and the log file too."""
    def lines(mod, name):
        err, sys.stderr = sys.stderr, io.StringIO()
        try:
            logger = mod.get_logger(name, log_file=str(tmp_path / f"{name}.log"))
            assert mod.get_logger(name) is logger
            logger.info("one %s", "x")
            logger.debug("hidden")
            text = sys.stderr.getvalue()
        finally:
            sys.stderr = err
        strip = re.compile(r"^\S+ \S+ ")  # the time stamp
        return ([strip.sub("", line).replace(name, "NAME") for line in text.splitlines()],
                [strip.sub("", line).replace(name, "NAME")
                 for line in open(tmp_path / f"{name}.log").read().splitlines()])

    got = lines(log_t, "ce_port_logger")
    assert got == lines(log_j, "ce_jax_logger")
    assert got[0] == ["[INFO] NAME: one x"]
    for name in ("ce_port_logger", "ce_jax_logger"):
        for h in logging.getLogger(name).handlers:
            h.close()


def test_timers_match_jax(monkeypatch):
    """The same step times give JAX's outliers, raise flag and report; a
    section timer fed the same clock gives JAX's report."""
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 3.0, 1.0, 2.0, 2.1, 2.2, 0.5, 9.0, 9.0, 9.0]
    a, b = prof_t.StepTimeMonitor(window=8, max_consecutive=2), prof_j.StepTimeMonitor(
        window=8, max_consecutive=2)
    for t in times:
        assert a.record(t) == b.record(t)
        assert a.should_raise == b.should_raise
    assert a.report() == b.report()
    assert prof_t.StepTimeMonitor().report() == {}

    clock = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    reports = []
    for mod in (prof_t, prof_j):
        timer = mod.SectionTimer()
        for name in ("load", "step", "load"):
            with timer.section(name):
                pass
        reports.append(timer.report())
        timer.reset()
        assert timer.report() == {}
    assert reports[0] == reports[1] == {"load": {"total_s": 2.0, "count": 2, "mean_s": 1.0},
                                        "step": {"total_s": 1.0, "count": 1, "mean_s": 1.0}}
