# The port's LM data pipeline (repro_torch.data.pipeline) against the JAX
# package's on the same documents: the vocabulary, the packed token rows
# and loss masks, and the ShardedLoader's batches, shards and chunks must be
# exactly equal; with the reference's own pipeline tests
# (tests/test_pipeline_reformat.py) run on the port.  The filter stage's
# plan runs on the CPU here.
import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.data import pipeline as jp  # noqa: E402
from repro_torch.data import pipeline as tp  # noqa: E402
from test_torch_threads import cap_torch_threads

cap_torch_threads()


def _docs(rng, n_docs, max_words=80, words=50):
    return [" ".join(f"w{x}" for x in rng.integers(0, words, rng.integers(1, max_words))) for _ in range(n_docs)]


def _both(docs, **kw):
    return (jp.build_dataset(docs, jp.PipelineConfig(**kw)),
            tp.build_dataset(docs, tp.PipelineConfig(device="cpu", **kw)))


def _same_dataset(a, b):
    assert a.vocab.id_to_token == b.vocab.id_to_token and a.vocab.token_to_id == b.vocab.token_to_id
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.loss_mask, b.loss_mask)
    assert a.tokens.dtype == b.tokens.dtype and a.loss_mask.dtype == b.loss_mask.dtype
    assert (a.n_docs, a.n_tokens, len(a)) == (b.n_docs, b.n_tokens, len(b))


@settings(max_examples=15, deadline=None)
@given(n_docs=st.integers(1, 60), seq_len=st.sampled_from([32, 64, 128]), seed=st.integers(0, 99),
       min_doc=st.integers(1, 12))
def test_property_dataset_equals_reference(n_docs, seq_len, seed, min_doc):
    docs = _docs(np.random.default_rng(seed), n_docs)
    a, b = _both(docs, seq_len=seq_len, min_doc_tokens=min_doc, vocab_size=256)
    _same_dataset(a, b)


@settings(max_examples=15, deadline=None)
@given(n_docs=st.integers(1, 60), seq_len=st.sampled_from([32, 64, 128]), seed=st.integers(0, 99))
def test_property_packing_invariants(n_docs, seq_len, seed):
    """The reference's packing invariants, on the port."""
    rng = np.random.default_rng(seed)
    docs = [" ".join(f"w{x}" for x in rng.integers(0, 50, rng.integers(1, 80))) for _ in range(n_docs)]
    ds = tp.build_dataset(docs, tp.PipelineConfig(seq_len=seq_len, min_doc_tokens=4, vocab_size=256, device="cpu"))
    assert ds.tokens.max() < ds.vocab.size
    assert ds.tokens.min() >= 0
    assert ((ds.tokens == tp.Vocab.PAD) == ~ds.loss_mask).all()
    assert ds.tokens.shape[1] == seq_len
    kept = [d for d in docs if len(d.split()) >= 4]
    assert ds.loss_mask.sum() == sum(len(d.split()) + 2 for d in kept)


@pytest.mark.parametrize("max_size", [6, 12, 65536])
def test_vocab_and_tokenize_equal_reference(max_size):
    texts = ["a b c a", "d e a b z z z", "q"]
    a, b = jp.build_vocab(texts, max_size), tp.build_vocab(texts, max_size)
    assert a.id_to_token == b.id_to_token and a.size == b.size
    for t in ("a z q", "nope a", ""):
        assert jp.tokenize(t, a) == tp.tokenize(t, b)
    assert (tp.Vocab.PAD, tp.Vocab.BOS, tp.Vocab.EOS, tp.Vocab.UNK) == (0, 1, 2, 3)


def test_vocab_specials_and_unk():
    v = tp.build_vocab(["a b c a"], max_size=6)
    assert v.id_to_token[:4] == ["<pad>", "<bos>", "<eos>", "<unk>"]
    ids = tp.tokenize("a z", v)
    assert ids[0] >= 4 and ids[1] == tp.Vocab.UNK


@pytest.mark.parametrize("n_shards,shard,seed", [(1, 0, 0), (4, 1, 7), (2, 1, 3)])
def test_loader_batches_shards_and_chunks_equal_reference(n_shards, shard, seed):
    docs = _docs(np.random.default_rng(0), 100, max_words=60)
    a, b = _both(docs, seq_len=64, min_doc_tokens=4)
    la = jp.ShardedLoader(a, global_batch=8, n_shards=n_shards, shard=shard, seed=seed)
    lb = tp.ShardedLoader(b, global_batch=8, n_shards=n_shards, shard=shard, seed=seed)
    assert la.n_batches() == lb.n_batches()
    for step in (0, 3, lb.n_batches(), 2 * lb.n_batches() + 1):  # past the epoch: wraps
        ba, bb = la.batch(step), lb.batch(step)
        for key in ("tokens", "loss_mask"):
            np.testing.assert_array_equal(ba[key], bb[key])
            np.testing.assert_array_equal(la.shard_slice(ba)[key], lb.shard_slice(bb)[key])
    assert la.chunks(10, 4) == lb.chunks(10, 4) == [(0, 4), (4, 4), (8, 2)]


def test_filter_program_equals_reference():
    from repro.core.ir import program_str as jax_program_str
    from repro_torch.core.ir import program_str

    assert program_str(tp.filter_documents_program(7)) == jax_program_str(jp.filter_documents_program(7))


def test_filter_stage_drops_short_documents():
    docs = ["a b", "a b c d e", "", "x y z w v u"]
    ds = tp.build_dataset(docs, tp.PipelineConfig(seq_len=8, min_doc_tokens=5, device="cpu"))
    assert ds.n_docs == 2
    assert ds.n_tokens == (5 + 2) + (6 + 2)
