"""Streaming word-count: the hello-world of stream processing.

FlatMap (line -> words, static max_fanout) -> per-key rolling count
(Accumulator, KEYBY routing) -> host sink, as a PipeGraph with a
self-checking result. Counterpart of ``examples/01_wordcount.py``.

    python -m windflow_tpu_torch.examples.wordcount [--device cpu]
"""

from __future__ import annotations

import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.examples._common import print_launches, start

# synthetic "documents": each source item i carries 3 word ids drawn from a
# zipf-ish table; the FlatMap ships one tuple per word
VOCAB = 50
TOTAL = 3000


def make_words(i):
    return {"w": torch.stack([(i * 7) % VOCAB, (i * 13) % VOCAB, (i * 29) % VOCAB])}


def split_words(t, shipper):
    for j in range(3):
        shipper.push({"word": t.w[j]})


def main(argv=None) -> None:
    dev = start(argv, __doc__)
    counts = {}

    def sink(view):
        if view is None:
            return
        for k, v in zip(view["key"].tolist(), view["payload"].tolist()):
            counts[k] = v            # rolling count per word id

    g = wt.PipeGraph("wordcount", batch_size=256, device=dev)
    (g.add_source(wt.Source(make_words, total=TOTAL, device=dev))
     .add(wt.FlatMap(split_words, max_fanout=3, device=dev))
     .add(wt.Map(lambda t: {"one": torch.ones((), dtype=torch.int32), "word": t.word},
                 device=dev))
     .add(wt.KeyBy(lambda t: t.word, num_keys=VOCAB, device=dev))
     .add(wt.Accumulator(lambda t: t.data["one"], init_value=0, num_keys=VOCAB,
                         device=dev))
     .add_sink(wt.Sink(sink, device=dev)))
    g.run()

    expect = {}
    for i in range(TOTAL):
        for w in ((i * 7) % VOCAB, (i * 13) % VOCAB, (i * 29) % VOCAB):
            expect[w] = expect.get(w, 0) + 1
    got = {k: int(v) for k, v in counts.items()}
    assert got == expect, "word counts diverge from the oracle"
    print_launches()
    print(f"wordcount OK: {len(got)} words, {sum(got.values())} total")


if __name__ == "__main__":
    main()
