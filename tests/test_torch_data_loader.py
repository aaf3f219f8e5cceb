"""The port's token loader (skypilot_tpu_torch/data/loader.py) held
against the JAX package's (skypilot_tpu/data/loader.py): the token file's
bytes both ways, the batches of every epoch, a resume at start_step,
disjoint shards and the errors, all exact."""
import numpy as np
import pytest
import torch

from skypilot_tpu.data import loader as jl
from skypilot_tpu_torch.data import loader as tl


@pytest.mark.parametrize('vocab', [50_000, 128_256])
def test_token_file_bytes_both_ways(tmp_path, vocab):
    """uint16 when the ids fit, uint32 past 2^16: each package's file is
    the other's byte for byte, and each loads the other's."""
    ids = np.random.default_rng(vocab).integers(0, vocab, 1_000)
    ids[0] = vocab - 1
    tl.write_token_file(str(tmp_path / 'port.bin'), ids)
    jl.write_token_file(str(tmp_path / 'jax.bin'), ids)
    assert (tmp_path / 'port.bin').read_bytes() == \
        (tmp_path / 'jax.bin').read_bytes()
    for name in ('port.bin', 'jax.bin'):
        mine = tl.TokenDataset(str(tmp_path / name))
        theirs = jl.TokenDataset(str(tmp_path / name))
        assert mine.tokens.dtype == theirs.tokens.dtype
        assert mine.tokens.dtype == (np.uint16 if vocab < 2 ** 16
                                     else np.uint32)
        np.testing.assert_array_equal(mine.tokens, ids)
        assert len(mine) == len(theirs) == 1_000
        assert mine.num_sequences(64) == theirs.num_sequences(64) == 15


def _batches(mod, ds, n, **kw):
    it = mod.token_batches(ds, **kw)
    return [next(it)['tokens'] for _ in range(n)]


def test_batches_epochs_resume_and_shards(tmp_path):
    """Three epochs of the JAX batches (the tail dropped and rotated), a
    resume at start_step 5 (mid-epoch), and four shards of the global
    batch: the same rows, disjoint, covering the JAX global batch."""
    ids = np.random.default_rng(0).integers(0, 30_000, 32 * 16 + 7)
    path = str(tmp_path / 't.bin')
    tl.write_token_file(path, ids)
    mine, theirs = tl.TokenDataset(path), jl.TokenDataset(path)
    kw = dict(batch_size=4, seq_len=16, seed=3,
              shard=tl.ShardInfo(0, 1))
    jkw = {**kw, 'shard': jl.ShardInfo(0, 1)}
    got = _batches(tl, mine, 24, **kw)       # 3 epochs of 8 steps
    want = _batches(jl, theirs, 24, **jkw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    # Epochs differ; within an epoch no sequence repeats.
    assert not np.array_equal(got[0], got[8])
    starts = [tuple(r[:3]) for b in got[:8] for r in b]
    assert len(set(starts)) == 32
    resumed = _batches(tl, mine, 6, **{**kw, 'start_step': 5})
    for g, w in zip(resumed, want[5:11]):
        np.testing.assert_array_equal(g, w)
    shards = [_batches(tl, mine, 3, **{**kw, 'batch_size': 8,
                                       'shard': tl.ShardInfo(i, 4)})
              for i in range(4)]
    whole = _batches(jl, theirs, 3, **{**jkw, 'batch_size': 8})
    for step in range(3):
        rows = np.concatenate([s[step] for s in shards])
        np.testing.assert_array_equal(rows, whole[step])
        assert all(s[step].shape == (2, 17) for s in shards)


def test_shard_batch_and_shard_info():
    """shard_batch puts this rank's rows on its device as tensors of the
    same values; with no process group ShardInfo.current() is 0 of 1."""
    rows = {'tokens': np.arange(12, dtype=np.int32).reshape(3, 4)}
    out = tl.shard_batch(rows, device='cpu')
    assert isinstance(out['tokens'], torch.Tensor)
    assert out['tokens'].device.type == 'cpu'
    np.testing.assert_array_equal(out['tokens'].numpy(), rows['tokens'])
    assert tl.ShardInfo.current() == tl.ShardInfo(0, 1)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tl.shard_batch(rows)


def test_errors_match(tmp_path):
    """The same error type and text as the JAX loader for each refusal."""
    path = str(tmp_path / 't.bin')
    tl.write_token_file(path, np.arange(100))
    bad = tmp_path / 'bad.bin'
    bad.write_bytes(b'NOTATOKENFILE' + b'\0' * 20)
    wide = tmp_path / 'wide.bin'
    wide.write_bytes(b'SKYTPUTOK1' + bytes([3]) + b'\0' * 13)
    cases = [
        lambda m: m.write_token_file(path, np.zeros((2, 2), np.int64)),
        lambda m: m.write_token_file(path, np.array([1, -1])),
        lambda m: m.TokenDataset(str(bad)),
        lambda m: m.TokenDataset(str(wide)),
        lambda m: next(m.token_batches(m.TokenDataset(path), 8, 16,
                                       shard=m.ShardInfo(0, 1))),
        lambda m: next(m.token_batches(m.TokenDataset(path), 3, 4,
                                       shard=m.ShardInfo(0, 2))),
    ]
    for case in cases:
        with pytest.raises(ValueError) as mine:
            case(tl)
        with pytest.raises(ValueError) as theirs:
            case(jl)
        assert str(mine.value).replace(str(tmp_path), '') == \
            str(theirs.value).replace(str(tmp_path), '')
