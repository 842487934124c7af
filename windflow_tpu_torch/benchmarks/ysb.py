"""Yahoo Streaming Benchmark (YSB) — the port's main path.

Counterpart of ``windflow_tpu/benchmarks/ysb.py`` with the user functions
written in torch (reference ``src/yahoo_test_cpu/test_ysb_kf.cpp``):

1. DeviceSource: synthetic ad events ``(ad_id, event_type)``, ``ts = i // 10``;
2. Filter: keep ``event_type == 0`` (views, 1 of 3);
3. BatchMap join: ``ad_id -> campaign`` through ``table_lookup`` on a
   1000-row device table (kernel K2 on the card);
4. KeyBy campaign;
5. Key_FFAT tumbling TB window counting views per campaign (kernel K1 on the
   card; the count lift is detected, so K3 does not run);
6. ReduceSink or a host Sink.

:func:`make_ops_sum` is the YSB-sum variant: the same chain with Key_FFAT
summing the int32 ``ad_id`` field, which drives the additive non-count lift
through ``segment_fold`` (kernel K3 on the card).

:func:`make_ops_wmr` is YSB-WMR (reference ``test_ysb_wmr.cpp``): the same
prefix with a Win_MapReduce window stage on the Win_Seq engine. MAP counts
each partition (``it.size()``), REDUCE sums the partial counts
(``it.sum()``, kernel K6 on the card); the engine's insert runs K2 twice and
K3 once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..basic import win_type_t
from ..batch import CTRL_DTYPE
from ..device import resolve_device
from ..operators.filter import Filter
from ..operators.map import BatchMap, KeyBy
from ..operators.sink import ReduceSink
from ..operators.source import DeviceSource
from ..operators.win_patterns import Key_FFAT, Win_MapReduce
from ..operators.window import WindowSpec
from ..ops.lookup import table_lookup
from ..runtime.pipeline import Pipeline

N_CAMPAIGNS = 100
ADS_PER_CAMPAIGN = 10
N_ADS = N_CAMPAIGNS * ADS_PER_CAMPAIGN
WIN_LEN = 100          # time units per tumbling window
EVENTS_PER_TICK = 10   # synthetic event-time rate: ts = i // EVENTS_PER_TICK


def campaign_table(device) -> torch.Tensor:
    """The static ad -> campaign fixture (``campaign_generator.hpp`` analogue)."""
    return torch.as_tensor(np.arange(N_ADS) // ADS_PER_CAMPAIGN, dtype=CTRL_DTYPE,
                           device=resolve_device(device))


def _prefix(num_keys: int, device, keep_ad: bool = False):
    """Filter -> campaign join -> KeyBy campaign (``keep_ad``: the join also
    carries ``ad_id`` on, for the YSB-sum window)."""
    camp_of = campaign_table(device)
    filt = Filter(lambda t: t.event_type == 0, name="ysb_filter", device=device)
    def join_fn(p):
        out = {"cmp": table_lookup(camp_of, p["ad_id"], traced=True)}
        if keep_ad:
            out["ad_id"] = p["ad_id"]
        return out
    join = BatchMap(join_fn, name="ysb_join", device=device)
    rekey = KeyBy(lambda t: t.cmp, num_keys, name="ysb_rekey", device=device)
    return [filt, join, rekey]


def make_ops(num_keys: int = N_CAMPAIGNS, win_len: int = WIN_LEN,
             pane_capacity: int = None, max_wins: int = None, device=None,
             count_lift: bool = None):
    """The YSB operator chain after the source (filter -> join -> window count)."""
    window = Key_FFAT(lambda t: torch.ones((), dtype=torch.int32), torch.add,
                      spec=WindowSpec(win_len, win_len, win_type_t.TB),
                      num_keys=num_keys, name="ysb_window",
                      pane_capacity=pane_capacity, max_wins=max_wins,
                      count_lift=count_lift, device=device)
    return _prefix(num_keys, device) + [window]


def make_ops_sum(num_keys: int = N_CAMPAIGNS, win_len: int = WIN_LEN,
                 pane_capacity: int = None, max_wins: int = None, device=None):
    """YSB-sum: per-campaign, per-window sum of the int32 ``ad_id`` field."""
    window = Key_FFAT(lambda t: t.ad_id, torch.add,
                      spec=WindowSpec(win_len, win_len, win_type_t.TB),
                      num_keys=num_keys, name="ysb_window_sum",
                      pane_capacity=pane_capacity, max_wins=max_wins, device=device)
    return _prefix(num_keys, device, keep_ad=True) + [window]


def make_ops_wmr(num_keys: int = N_CAMPAIGNS, win_len: int = WIN_LEN,
                 map_parallelism: int = 2, device=None, **engine_kw):
    """YSB with a Win_MapReduce window stage: each window's content
    partitioned over MAP workers, partial counts combined by REDUCE.
    ``engine_kw`` (``max_wins``, ``tb_capacity``, ...) goes to the Win_Seq
    engine; large batches need an explicit fired-window budget (the engine's
    default budget guard raises)."""
    window = Win_MapReduce(lambda wid, it: it.size(),
                           lambda wid, it: it.sum(),
                           WindowSpec(win_len, win_len, win_type_t.TB),
                           map_parallelism=map_parallelism, num_keys=num_keys,
                           name="ysb_window_wmr", device=device, **engine_kw)
    return _prefix(num_keys, device) + [window]


def wmr_bench_geometry(batch: int, win_len: int) -> dict:
    """Win_Seq engine geometry of ``bench.py::bench_ysb_wmr``: a fired-window
    budget of every campaign's windows per batch plus two, and an 8192-slot
    ring per campaign."""
    wins_per_batch = batch // (EVENTS_PER_TICK * win_len) + 1
    return {"max_wins": N_CAMPAIGNS * (wins_per_batch + 2), "tb_capacity": 8192}


def make_source(total: int, name: str = "ysb_source", device=None) -> DeviceSource:
    def gen(i):
        return {"ad_id": (i * 7919) % N_ADS,     # pseudo-random ad (int32 wrap)
                "event_type": i % 3}
    return DeviceSource(gen, total=total, name=name,
                        key_fn=lambda i: (i * 7919) % N_ADS % N_CAMPAIGNS,
                        ts_fn=lambda i: i // EVENTS_PER_TICK, device=device)


def make_pipeline(total: int, batch_size: int = 8192, count_sink: bool = True,
                  device=None) -> Pipeline:
    ops = make_ops(device=device)
    if count_sink:
        ops.append(ReduceSink(lambda t: t.data, name="ysb_windows_total",
                              device=device))
    return Pipeline(make_source(total, device=device), ops, batch_size=batch_size,
                    device=device)


def bench_geometry(batch: int) -> dict:
    """Pane-ring geometry of ``bench.py::bench_ysb`` for a batch size: the ring
    holds two batches plus the window span; the fired-window budget one
    batch's panes plus 64."""
    panes_per_batch = batch // (EVENTS_PER_TICK * WIN_LEN) + 1
    return {"pane_capacity": 2 * panes_per_batch + 2,
            "max_wins": panes_per_batch + 64}


def oracle_totals(total: int) -> int:
    """Total view events (the sum of all window counts must equal this)."""
    return (total + 2) // 3


def dense_oracle(total: int, value: str = "count", win_len: int = WIN_LEN) -> dict:
    """``{(campaign, window): count or sum of ad ids}`` over views of
    ``win_len``-tick tumbling windows, computed with numpy from the stream's
    definition (int32 wrap included)."""
    i = np.arange(total, dtype=np.int32)
    i = i[i % 3 == 0]
    ad = (i * np.int32(7919)) % N_ADS
    camp = ad // ADS_PER_CAMPAIGN
    wid = (i // EVENTS_PER_TICK) // win_len
    n_w = int(wid.max()) + 1 if len(wid) else 0
    cell = camp.astype(np.int64) * n_w + wid
    weights = None if value == "count" else ad.astype(np.int64)
    counts = np.bincount(cell, weights=weights, minlength=N_CAMPAIGNS * n_w)
    nz = np.nonzero(np.bincount(cell, minlength=N_CAMPAIGNS * n_w))[0]
    return dict(zip(zip((nz // n_w).tolist(), (nz % n_w).tolist()),
                    counts[nz].astype(np.int64).tolist()))
