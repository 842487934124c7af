"""The Yahoo Streaming Benchmark pipeline at example scale.

DeviceSource -> Filter(view events) -> campaign join (kernel K2's table
lookup) -> KeyBy(campaign) -> per-campaign tumbling time window counting
views (kernel K1's pane histogram) -> sink. ``chip_smoke.py`` runs it at
2^20-tuple batches on the card; this example runs it small and checks the
window counts against an oracle. Counterpart of ``examples/02_ysb_windows.py``.

    python -m windflow_tpu_torch.examples.ysb_windows [--device cpu]
"""

from __future__ import annotations

import windflow_tpu_torch as wt
from windflow_tpu_torch.benchmarks import ysb
from windflow_tpu_torch.examples._common import print_launches, start

TOTAL = 40_000


def main(argv=None) -> None:
    dev = start(argv, __doc__)
    results = []

    def sink(view):
        if view is None:
            return
        results.extend(zip(view["key"].tolist(), view["id"].tolist(),
                           view["payload"].tolist()))

    src = ysb.make_source(total=TOTAL, device=dev)
    wt.Pipeline(src, ysb.make_ops(device=dev), wt.Sink(sink, device=dev),
                batch_size=4096, device=dev).run()

    # oracle: replay the generator's arithmetic on the host
    views = [i for i in range(TOTAL) if (i % 3) == 0]
    expect = {}
    for i in views:
        camp = (i * 7919) % ysb.N_ADS // ysb.ADS_PER_CAMPAIGN
        win = (i // ysb.EVENTS_PER_TICK) // ysb.WIN_LEN
        expect[(camp, win)] = expect.get((camp, win), 0) + 1
    got = {(k, w): int(c) for k, w, c in results}
    assert got == expect, "window counts diverge from the oracle"
    print_launches()
    print(f"YSB example OK: {len(got)} windows over {len(set(k for k, _ in got))} campaigns")


if __name__ == "__main__":
    main()
