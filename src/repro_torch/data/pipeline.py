# The LM training-data pipeline, built as forelem programs over multisets
# and optimized by the same pass pipeline as any SQL query (vertical
# integration, paper §II): ingest → filter → dictionary-encode (tokenize) →
# pack → batch.
#
#   documents(doc_id, text)                         [raw multiset]
#     → filter:   forelem over Filtered index set   (length / quality preds)
#     → tokens(doc_id, pos, token):                 dictionary encoding —
#         the paper's §III-C1 reformatting: "the strings ... replaced with
#         integer keys ... the data model has been made relational"
#     → vocab stats: the URL-count group-by         (SQL frontend)
#     → packed sequences: compressed-range position columns
#     → per-worker shards: direct partitioning      (loop blocking §III-A1)
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (
    BinOp,
    Const,
    FieldRef,
    Filtered,
    Forelem,
    Program,
    ResultAppend,
    TupleExpr,
    optimize,
    OptimizeOptions,
)
from repro_torch.data.multiset import Database, Multiset

# ---------------------------------------------------------------------------
# Tokenizer (whitespace/word-level dictionary encoder — the reformatting
# step; a byte-fallback keeps the vocab closed)
# ---------------------------------------------------------------------------


@dataclass
class Vocab:
    token_to_id: Dict[str, int]
    id_to_token: List[str]

    PAD = 0
    BOS = 1
    EOS = 2
    UNK = 3

    @property
    def size(self) -> int:
        return len(self.id_to_token)


def build_vocab(texts: Sequence[str], max_size: int = 65536) -> Vocab:
    """Vocabulary = the distinct-value index set of the token column, i.e.
    the group-by/count query of paper §IV ranked by frequency."""
    counts: Dict[str, int] = {}
    for t in texts:
        for w in t.split():
            counts[w] = counts.get(w, 0) + 1
    specials = ["<pad>", "<bos>", "<eos>", "<unk>"]
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    id_to_token = specials + [w for w, _ in ranked[: max_size - len(specials)]]
    return Vocab({w: i for i, w in enumerate(id_to_token)}, id_to_token)


def tokenize(text: str, vocab: Vocab) -> List[int]:
    return [vocab.token_to_id.get(w, Vocab.UNK) for w in text.split()]


# ---------------------------------------------------------------------------
# Pipeline stages
# ---------------------------------------------------------------------------


@dataclass
class PipelineConfig:
    seq_len: int = 512
    min_doc_tokens: int = 4
    vocab_size: int = 65536
    pack: bool = True          # document packing into fixed-length rows
    seed: int = 0
    # device the filter stage's plan runs on: None = the card, 'cpu' on
    # the CPU (the arrays it yields are numpy either way)
    device: Optional[str] = None


def filter_documents_program(min_len: int) -> Program:
    """The filter stage *as a forelem program* (so DCE/fusion/reformat passes
    apply): SELECT doc_id, n_tokens FROM docs WHERE n_tokens >= :min."""
    pred = BinOp(">=", FieldRef("docs", "_", "n_tokens"), Const(min_len))
    body = (
        Forelem(
            "i",
            Filtered("docs", pred),
            (ResultAppend("R", TupleExpr((FieldRef("docs", "i", "doc_id"), FieldRef("docs", "i", "n_tokens")))),),
        ),
    )
    from repro_torch.core.ir import MultisetDecl, TupleSchema

    decls = (MultisetDecl("docs", TupleSchema((("doc_id", "int32"), ("n_tokens", "int32")))),)
    return Program(decls, body, ("R",), (), "filter_docs")


@dataclass
class PackedDataset:
    """Fixed-length packed token rows + boundary metadata.

    positions/segment columns are stored as compressed ranges where
    possible (paper §III-C1 'compressed column schemes')."""

    tokens: np.ndarray        # (n_rows, seq_len) int32
    loss_mask: np.ndarray     # (n_rows, seq_len) bool (False on pad)
    n_docs: int
    vocab: Vocab

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def n_tokens(self) -> int:
        return int(self.loss_mask.sum())


def build_dataset(texts: Sequence[str], cfg: PipelineConfig) -> PackedDataset:
    """Run the full pipeline.  The relational stages run through the forelem
    optimizer; packing materializes the final physical layout."""
    vocab = build_vocab(texts, cfg.vocab_size)
    toks = [tokenize(t, vocab) for t in texts]

    # --- filter stage via the IR (vertical integration in action) ---------
    docs = Multiset.from_columns(
        "docs",
        doc_id=np.arange(len(toks), dtype=np.int32),
        n_tokens=np.asarray([len(t) for t in toks], dtype=np.int32),
    )
    db = Database().add(docs)
    prog = filter_documents_program(cfg.min_doc_tokens)
    res = optimize(prog, db, OptimizeOptions(n_parts=1, reformat=False, device=cfg.device))
    kept = [int(d) for d, _n in res.plan.run()["R"]]

    # --- pack into fixed rows (BOS/EOS per doc, greedy fill) --------------
    S = cfg.seq_len
    rows: List[List[int]] = []
    cur: List[int] = []
    for di in kept:
        seq = [Vocab.BOS] + toks[di] + [Vocab.EOS]
        while seq:
            space = S - len(cur)
            cur.extend(seq[:space])
            seq = seq[space:]
            if len(cur) == S:
                rows.append(cur)
                cur = []
    if cur:
        cur.extend([Vocab.PAD] * (S - len(cur)))
        rows.append(cur)
    tokens = np.asarray(rows, dtype=np.int32)
    loss_mask = tokens != Vocab.PAD
    return PackedDataset(tokens, loss_mask, len(kept), vocab)


# ---------------------------------------------------------------------------
# Sharded loader: direct data partitioning (§III-A1) + the chunk interface
# the fault-tolerant scheduler consumes
# ---------------------------------------------------------------------------


@dataclass
class ShardedLoader:
    """Deterministic per-worker batch iterator.  The epoch's row index set
    is blocked into `n_shards` partitions (pA = p1A ∪ … ∪ pNA); chunk
    handles (start, size) are what sched.fault_tolerant re-queues on
    failure."""

    dataset: PackedDataset
    global_batch: int
    n_shards: int = 1
    shard: int = 0
    seed: int = 0
    drop_remainder: bool = True

    def __post_init__(self):
        self._order = np.random.default_rng(self.seed).permutation(len(self.dataset))

    def n_batches(self) -> int:
        return len(self.dataset) // self.global_batch

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Global batch for `step`; each worker slices its shard."""
        idx = self._order[(step * self.global_batch) % len(self._order):][: self.global_batch]
        if len(idx) < self.global_batch:  # wrap the epoch
            idx = np.concatenate([idx, self._order[: self.global_batch - len(idx)]])
        return {
            "tokens": self.dataset.tokens[idx],
            "loss_mask": self.dataset.loss_mask[idx],
        }

    def shard_slice(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        per = self.global_batch // self.n_shards
        lo = self.shard * per
        return {k: v[lo : lo + per] for k, v in batch.items()}

    def chunks(self, total_steps: int, chunk_size: int) -> List[Tuple[int, int]]:
        """(start_step, n_steps) chunks for the dynamic scheduler."""
        return [(s, min(chunk_size, total_steps - s)) for s in range(0, total_steps, chunk_size)]
