"""Synthetic token pipeline with checkpointable state and an AQP-planned
mixture: the reference's ``train/data.py`` over the port's engine.

The pipeline is organized in *blocks* (shard slabs), matching the paper's
storage model: a corpus is a set of domains, each a sequence of fixed-size
token blocks.  Mixture weights can be computed by an approximate query over
the corpus-metadata table through the port's PilotDB
(:func:`plan_mixture_weights`): "what fraction of high-quality tokens does
each domain hold?" is a grouped AVG with an a-priori error bound, answered
from a block sample instead of a full metadata scan.  The table lives on the
device (``BlockTable.from_numpy``); on the card a grouped AVG takes the
gather route and ``segment_sum``.  Batches are numpy, drawn from the same
``default_rng((seed, step))`` stream as the reference's, byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import CompositeAgg, ErrorSpec, PilotDB, Query
from repro_torch.engine import logical as L
from repro_torch.engine.executor import Executor
from repro_torch.engine.expr import Col
from repro_torch.engine.table import BlockTable


@dataclasses.dataclass
class DataState:
    """Checkpointable cursor: rng state + per-domain block cursors."""

    seed: int
    step: int
    cursors: Dict[str, int]

    def to_json(self):
        return {"seed": self.seed, "step": self.step, "cursors": dict(self.cursors)}

    @staticmethod
    def from_json(d):
        return DataState(seed=int(d["seed"]), step=int(d["step"]),
                         cursors=dict(d["cursors"]))


class TokenPipeline:
    """Deterministic, resumable synthetic LM batches."""

    def __init__(self, vocab_size: int, batch: int, seq: int, *,
                 domains: Optional[Dict[str, float]] = None, seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.domains = domains or {"default": 1.0}
        total = sum(self.domains.values())
        self.weights = {k: v / total for k, v in self.domains.items()}
        self.state = DataState(seed=seed, step=0,
                               cursors={k: 0 for k in self.domains})

    def next_batch(self) -> Dict[str, np.ndarray]:
        # stateless-per-step RNG: resume-exact after checkpoint restore
        rng = np.random.default_rng((self.state.seed, self.state.step))
        names = sorted(self.weights)
        probs = np.array([self.weights[k] for k in names])
        doms = rng.choice(len(names), size=self.batch, p=probs)
        tokens = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1),
                              dtype=np.int32)
        # domain imprint: offsets make batches domain-distinguishable
        tokens = (tokens + doms[:, None] * 17) % self.vocab
        for d in doms:
            self.state.cursors[names[d]] += 1
        self.state.step += 1
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def make_domain_metadata(num_blocks_per_domain: Dict[str, int], *,
                         block_rows: int = 128, seed: int = 0,
                         device="cuda") -> BlockTable:
    """Corpus-metadata table on ``device``: one row per token block with a
    quality score.  Domains are integer-coded in sorted-name order."""
    rng = np.random.default_rng(seed)
    rows_dom, rows_q, rows_tok = [], [], []
    for code, name in enumerate(sorted(num_blocks_per_domain)):
        n = num_blocks_per_domain[name] * block_rows
        rows_dom.append(np.full(n, code, np.int32))
        # per-domain quality distributions differ -> mixture weights differ
        rows_q.append(rng.beta(2.0 + code, 2.0, n).astype(np.float32))
        rows_tok.append(rng.integers(512, 2048, n).astype(np.float32))
    dom = np.concatenate(rows_dom)
    # interleave domains across blocks (ingest order in real corpora mixes
    # shards); contiguous layout would be Lemma 4.1's homogeneous-block
    # worst case and force the planner to exact execution
    perm = rng.permutation(len(dom))
    return BlockTable.from_numpy(
        "corpus_meta",
        {"domain": dom[perm],
         "quality": np.concatenate(rows_q)[perm],
         "tokens": np.concatenate(rows_tok)[perm]},
        block_rows, device=device)


def plan_mixture_weights(meta: BlockTable, num_domains: int, *,
                         error: float = 0.1, confidence: float = 0.9,
                         seed: int = 0) -> Tuple[Dict[int, float], object]:
    """AQP-planned mixture: per-domain mean quality with (e, p) guarantees,
    normalized into sampling weights, on the table's device.  Returns
    (weights, TaqaReport)."""
    db = PilotDB(Executor({"corpus_meta": meta}, device=meta.device),
                 large_table_rows=10_000)
    q = Query(child=L.Scan("corpus_meta"),
              aggs=(CompositeAgg("q", "avg", Col("quality")),),
              group_by="domain", max_groups=num_domains)
    ans = db.query(q, ErrorSpec(error=error, confidence=confidence), seed=seed)
    vals = ans.values[0]
    present = ans.group_present
    w = {g: float(max(vals[g], 0.0)) for g in range(num_domains) if present[g]}
    total = sum(w.values()) or 1.0
    return {g: v / total for g, v in w.items()}, ans.report
