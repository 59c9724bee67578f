"""Drivers of the program under test, one module per ``system`` that a
configuration file names.

A driver runs only what its tables name: every traffic ``entry`` and every
configuration value that picks a path (corpus, storage dtype, build method)
is looked up with :func:`choose`, and every key of a configuration or
traffic file has to be one the driver reads (:func:`refuse_unknown`). A
data file that asks for anything else is refused at set-up, so a new cell
never times another path under its own name; a new path needs a new entry
in a driver's table.

:class:`SearchLoop` is what the search drivers share: the pools of batches
drawn at set-up, the warm-up on a pool of its own, one batch a window step
with its ids and scores copied to the host, and the reference's navigation
counted for the roofline metrics.
"""

from __future__ import annotations

import torch

from .. import datagen
from ..reference import search_ref

# keys that describe a configuration and steer nothing
DESCRIBE = frozenset({"name", "system", "source", "deployment", "reduced",
                      "assumed", "published", "precision"})
# the search traffic every driver here reads: a closed loop with one
# caller, like-documents uniform over the rows and excluded from their own
# answers, Dirichlet field weights
SEARCH_TRAFFIC = frozenset({"entry", "loop", "like", "batch", "k", "alpha",
                            "pool_batches", "warmup_batches"})
LOOPS = {"closed": "one caller, each batch's results on the host before "
                   "the next is sent"}
LIKES = {"uniform_excluded": "like-documents uniform over the rows, each "
                             "excluded from its own answer"}

_WARMUP_STREAM = 5
_WORK_CHUNK = 16          # batches navigated at once when counting work


def choose(data: dict, key: str, table: dict, what: str):
    """``table[data[key]]``; a value the table does not name is refused."""
    value = data.get(key)
    if value not in table:
        raise ValueError(
            f"{what} {key}={value!r}: this driver runs only "
            f"{sorted(table)}; another needs a driver that runs it")
    return table[value]


def refuse_unknown(data: dict, known, what: str) -> None:
    """Refuse a key that nothing reads (it would be ignored silently)."""
    extra = sorted(set(data) - set(known) - DESCRIBE)
    if extra:
        raise ValueError(f"{what} has keys this driver does not read: "
                         f"{extra}")


class SearchLoop:
    """Batches of weighted more-like-this queries in a closed loop. A
    subclass sets ``traffic``, ``seed``, ``dev``, ``dims``, ``n`` and
    implements ``_search(like, w) -> (scores, ids)`` on the card."""

    def _check_search_traffic(self, known_extra=()) -> None:
        refuse_unknown(self.traffic, SEARCH_TRAFFIC | set(known_extra),
                       "traffic")
        choose(self.traffic, "loop", LOOPS, "traffic")
        choose(self.traffic, "like", LIKES, "traffic")

    def _draw_and_warm(self) -> None:
        tr = self.traffic
        self.pool = datagen.traffic_pool(tr, self.n, int(tr["pool_batches"]),
                                         self.seed, len(self.dims), self.dev)
        self.host = datagen.host_results(tr)
        warm = datagen.traffic_pool(tr, self.n, int(tr["warmup_batches"]),
                                    self.seed * 7 + _WARMUP_STREAM,
                                    len(self.dims), self.dev)
        for i in range(int(tr["warmup_batches"])):
            self._search(warm["like"][i], warm["weights"][i])
        self._sync()

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def queries_per_step(self) -> int:
        return int(self.traffic["batch"])

    def run_once(self, i: int, label):
        """Window step ``i``: one batch, its result on the host."""
        like, w = datagen.pool_batch(self.pool, i)
        j = i % self.host[0].shape[0]
        with label("bench.search"):
            s, ids = self._search(like, w)
        with label("bench.to_host"):
            self.host[0][j].copy_(s)
            self.host[1][j].copy_(ids)
        return self.host[0][j], self.host[1][j]

    def _navigated(self, n_steps: int, leaders, buckets, counts, probes_t):
        """The reference's navigation of the window's ``n_steps`` batches,
        summed: ``(pack rows or None, distinct rows, distinct pairs)`` (see
        ``search_ref.probe_work``)."""
        nq = int(self.traffic["batch"])
        total = [0, 0, 0]
        for lo in range(0, n_steps, _WORK_CHUNK):
            like, w = datagen.pool_chunk(self.pool, lo,
                                         min(n_steps, lo + _WORK_CHUNK))
            qw = search_ref.weighted_query(self.docs[like], w, self.dims)
            got = search_ref.probe_work(qw, leaders, buckets, counts,
                                        probes_t, self.n, nq)
            total = [t + (0 if g is None else int(g))
                     for t, g in zip(total, got)]
        return (total[0] if counts is not None else None,
                total[1], total[2])
