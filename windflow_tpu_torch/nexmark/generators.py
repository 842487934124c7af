"""Nexmark event generators: deterministic on-device synthetic streams.

Counterpart of ``windflow_tpu/nexmark/generators.py``, with the same
constants. Every source is a ``DeviceSource`` whose fields are int32 functions
of the global event index ``i``, computed in int32 arithmetic as in the JAX
package: ``i * 2477`` and ``i * 7919`` wrap at 2^31 (from i = 866,970 and
i = 271,183), and ``%`` is the floored remainder, so both packages generate
the same stream at any length. Event time advances ``EVENTS_PER_TICK``
events per tick. The tagged sources interleave two logical streams into one
(the ``side`` payload field).
"""

from __future__ import annotations

import torch

from ..operators.source import DeviceSource

EVENTS_PER_TICK = 8     # ts = i // EVENTS_PER_TICK
N_AUCTIONS = 16
N_BIDDERS = 8
N_CATEGORIES = 7
PRICE_MOD = 9973        # pseudo-random bid price: (i * 7919) % PRICE_MOD + 100
OPEN_EVERY = 16         # every OPEN_EVERY-th event of the tagged join stream
                        # opens an auction (the interval join's left side)

_I32 = torch.int32


def bid_auction(i):
    return (i * 2477) % N_AUCTIONS


def bid_bidder(i):
    # irregular per-bidder inter-arrival times: session gaps depend on data
    return ((i % 7) * (i % 11) + i // 13) % N_BIDDERS


def bid_price(i):
    return (i * 7919) % PRICE_MOD + 100


def _ts(i):
    return i // EVENTS_PER_TICK


def make_bid_source(total: int, name: str = "nexmark_bids", device=None) -> DeviceSource:
    """The plain bid stream: ``{auction, bidder, price}`` keyed by auction."""
    def gen(i):
        return {"auction": bid_auction(i).to(_I32), "bidder": bid_bidder(i).to(_I32),
                "price": bid_price(i).to(_I32)}
    return DeviceSource(gen, total=total, name=name, key_fn=bid_auction, ts_fn=_ts,
                        device=device)


def make_enrich_source(total: int, name: str = "nexmark_enrich",
                       n_auctions: int = N_AUCTIONS, device=None) -> DeviceSource:
    """Tagged stream for the stream-table join: events ``0 .. n_auctions-1``
    define the auctions (``side == 1``, ``category`` set), the rest are bids
    (``side == 0``). Definitions precede every bid in event time, so probe
    results do not depend on batching."""
    n_auctions = int(n_auctions)

    def auction(i):
        return torch.where(i < n_auctions, i, (i * 2477) % n_auctions)

    def gen(i):
        is_def = i < n_auctions
        return {"side": torch.where(is_def, 1, 0).to(_I32),
                "auction": auction(i).to(_I32),
                "category": torch.where(is_def, (i * 13) % N_CATEGORIES, 0).to(_I32),
                "price": torch.where(is_def, 0, bid_price(i)).to(_I32)}
    return DeviceSource(gen, total=total, name=name, key_fn=auction, ts_fn=_ts,
                        device=device)


def make_open_bid_source(total: int, name: str = "nexmark_open_bid",
                         device=None) -> DeviceSource:
    """Tagged stream for the interval join (q4): every ``OPEN_EVERY``-th event
    opens an auction (``side == 1``), the rest are bids."""
    def auction(i):
        return torch.where((i % OPEN_EVERY) == 0, (i // OPEN_EVERY) % N_AUCTIONS,
                           bid_auction(i))

    def gen(i):
        is_open = (i % OPEN_EVERY) == 0
        return {"side": torch.where(is_open, 1, 0).to(_I32),
                "auction": auction(i).to(_I32),
                "price": torch.where(is_open, 0, bid_price(i)).to(_I32)}
    return DeviceSource(gen, total=total, name=name, key_fn=auction, ts_fn=_ts,
                        device=device)
