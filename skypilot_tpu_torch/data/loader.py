"""Tokenized-corpus data loading: memmap datasets -> rank-local batches.
The port's own copy of ``skypilot_tpu/data/loader.py`` (the port imports
nothing of the JAX package, not even this JAX-free module).

- ``TokenDataset`` -- a flat binary file of token ids, memory-mapped
  (the nanoGPT ``.bin`` convention).  The ``SKYTPUTOK1`` header and the
  bytes are the JAX package's: a file written by either loads in the
  other.
- ``token_batches`` -- deterministic, seeded, epoch-shuffled [B, T+1]
  batches: the same rows as the JAX function for the same (seed, epoch),
  shard and ``start_step``.
- ``shard_batch`` -- rank-local numpy rows -> tensors on the rank's
  device (each process holds only its rows; the trainer takes them as
  this rank's share of the global batch).
- ``write_token_file`` / ``tokenize_text_file`` -- produce the binary
  from token ids or raw text + an HF tokenizer.
"""
import dataclasses
import os
from typing import Dict, Iterator, Optional

import numpy as np

_MAGIC = b'SKYTPUTOK1'     # 10-byte header magic
_DTYPES = {2: np.uint16, 4: np.uint32}


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a flat token-id array as a memmap-able binary file.

    Format: 10-byte magic + 1 byte dtype width (2|4) + 5 reserved bytes,
    then little-endian token ids.  uint16 when the vocab fits (GPT-2,
    Llama-2 32k), uint32 otherwise (Llama-3 128k).
    """
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f'tokens must be 1-D, got shape {tokens.shape}')
    if tokens.size and tokens.min() < 0:
        raise ValueError('negative token ids')
    width = 2 if (tokens.size == 0 or tokens.max() < 2**16) else 4
    dtype = _DTYPES[width]
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(_MAGIC + bytes([width]) + b'\x00' * 5)
        le = np.dtype(dtype).newbyteorder('<')
        f.write(np.ascontiguousarray(tokens, dtype=le).tobytes())
    os.replace(tmp, path)   # atomic: readers never see a partial file


def tokenize_text_file(text_path: str, out_path: str,
                       tokenizer_name: str,
                       append_eos: bool = True) -> int:
    """Tokenize a UTF-8 text file with an HF tokenizer into a token file.
    Returns the token count."""
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(tokenizer_name)
    with open(text_path, 'r', encoding='utf-8') as f:
        ids = tok.encode(f.read())
    if append_eos and tok.eos_token_id is not None:
        ids = list(ids) + [tok.eos_token_id]
    write_token_file(out_path, np.asarray(ids, dtype=np.int64))
    return len(ids)


class TokenDataset:
    """Memory-mapped flat token stream (read-only)."""

    def __init__(self, path: str):
        with open(path, 'rb') as f:
            header = f.read(16)
        if header[:10] != _MAGIC:
            raise ValueError(
                f'{path} is not a skytpu token file (bad magic); create '
                'it with write_token_file/tokenize_text_file')
        width = header[10]
        if width not in _DTYPES:
            raise ValueError(f'{path}: unsupported token width {width}')
        self.path = path
        self.tokens = np.memmap(path, dtype=_DTYPES[width], mode='r',
                                offset=16)

    def __len__(self) -> int:
        return int(self.tokens.shape[0])

    def num_sequences(self, seq_len: int) -> int:
        """Complete (seq_len+1)-token windows (input+shifted target)."""
        return max(0, (len(self) - 1) // seq_len)


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """This process's share of the global batch.  Defaults to the current
    process; pass explicitly in tests."""
    index: int = 0
    count: int = 1

    @classmethod
    def current(cls, mesh=None) -> 'ShardInfo':
        """With a mesh: this rank's coordinate over its batch axes
        ('data', 'fsdp'), so ranks that differ only in 'seq', 'tensor' or
        'stage' read the same rows.  Without one: the process group's rank
        and world size (0 of 1 with no group)."""
        from torch import distributed as dist
        if mesh is not None:
            return cls(index=mesh.coord('data', 'fsdp'),
                       count=mesh.size('data', 'fsdp'))
        if not dist.is_initialized():
            return cls()
        return cls(index=dist.get_rank(), count=dist.get_world_size())


def token_batches(dataset: TokenDataset, batch_size: int, seq_len: int,
                  seed: int = 0,
                  shard: Optional[ShardInfo] = None,
                  start_step: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Seeded epoch-shuffled [batch_size, seq_len+1] batches, forever.

    - batch_size is the GLOBAL batch (sequences); this host yields its
      ``batch_size // shard.count`` rows — feed through ``shard_batch``.
      shard defaults to the current process (ShardInfo.current()).
    - Each epoch is a fresh permutation of all complete sequences,
      seeded by (seed, epoch): identical across hosts (so shards are
      disjoint) and across restarts.  The tail remainder
      (``n_seq % batch_size`` sequences) is dropped each epoch
      (drop-last); since the permutation differs per epoch, dropped
      sequences rotate and everything is seen across epochs.
    - start_step skips ahead deterministically — resume without
      replaying data (the trainer's restored step is the argument).
    """
    shard = shard or ShardInfo.current()
    if batch_size % shard.count:
        raise ValueError(f'global batch {batch_size} not divisible by '
                         f'host count {shard.count}')
    local_bs = batch_size // shard.count
    n_seq = dataset.num_sequences(seq_len)
    if n_seq < batch_size:
        raise ValueError(
            f'dataset has {n_seq} complete sequences of length '
            f'{seq_len + 1}; need at least one global batch '
            f'({batch_size})')
    steps_per_epoch = n_seq // batch_size
    step = start_step
    while True:
        epoch = step // steps_per_epoch
        rng = np.random.default_rng((seed, epoch))
        order = rng.permutation(n_seq)
        while step // steps_per_epoch == epoch:
            i = step % steps_per_epoch
            rows = order[i * batch_size:(i + 1) * batch_size]
            mine = rows[shard.index * local_bs:(shard.index + 1) * local_bs]
            batch = np.stack([
                np.asarray(dataset.tokens[r * seq_len:
                                          r * seq_len + seq_len + 1])
                for r in mine
            ]).astype(np.int32)
            yield {'tokens': batch}
            step += 1


def shard_batch(batch: Dict[str, np.ndarray], mesh=None,
                device=None) -> Dict:
    """This rank's rows -> tensors on its device (the mesh's rank device,
    or `device`; None means the card).  Each rank contributes its local
    rows; the trainer takes a batch of ``batch_size / (data * fsdp)`` rows
    as this rank's share of the global batch."""
    import torch

    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    dev = (mesh_lib.rank_device(mesh) if mesh is not None
           else resolve_device(device))
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in batch.items()}
