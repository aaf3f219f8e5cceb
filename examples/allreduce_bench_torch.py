"""All-reduce bandwidth benchmark -- the PyTorch twin of
examples/ici_allreduce_bench.py (the analog of the reference's
examples/nccl_test.yaml).

``torch.distributed.all_reduce`` of one payload per rank, over NCCL on
the cards (NVLink within a host) and gloo with ``--device cpu``.  Prints
the reference's lines: the algorithm bandwidth (payload / time) and the
bus bandwidth (algbw * 2(n-1)/n, the ring-transfer bound), the metrics
NCCL's own benchmark prints.  One rank moves nothing, so its busbw is 0.

Launch one process per card with torchrun (or under the podlet's env); a
plain ``python`` run is one rank:
  torchrun --nproc-per-node 8 examples/allreduce_bench_torch.py
  torchrun --standalone --nproc-per-node 2 examples/allreduce_bench_torch.py \\
      --device cpu --payload-mb 8
"""
import argparse
import time

import torch
from torch import distributed as dist


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--payload-mb', type=float, default=1024.0,
                        help='All-reduce payload per device, MB.')
    parser.add_argument('--trials', type=int, default=5)
    parser.add_argument('--dtype', default='bfloat16',
                        choices=['bfloat16', 'float32'])
    parser.add_argument('--device', default=None, choices=['cuda', 'cpu'],
                        help='default: the CUDA cards (raises without '
                             'one); cpu runs the ranks over gloo')
    args = parser.parse_args(argv)

    from skypilot_tpu_torch.parallel import mesh as mesh_lib

    device = mesh_lib.ensure_process_group(args.device)
    n = dist.get_world_size()
    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    itemsize = 2 if args.dtype == 'bfloat16' else 4
    per_dev_elems = int(args.payload_mb * 1e6 / itemsize)
    payload_bytes = per_dev_elems * itemsize
    x = torch.ones(per_dev_elems, dtype=dtype, device=device)

    def sync():
        # A host read of the result: every rank's collective is done.
        float(x[:1].float().sum())

    # Warm-up: the communicator and its buffers, outside the timed trials.
    dist.all_reduce(x)
    sync()
    times = []
    for _ in range(args.trials):
        dist.barrier()
        t0 = time.time()
        dist.all_reduce(x)
        sync()
        times.append(time.time() - t0)

    avg = sum(times) / len(times)
    algbw = payload_bytes / avg / 1e9
    busbw = algbw * 2 * (n - 1) / n
    if dist.get_rank() == 0:
        print(f'The average bandwidth of all_reduce with a '
              f'{payload_bytes / 1e9:.1f}GB payload per device '
              f'({args.trials} trials, {n} devices, {args.dtype}):')
        print(f' algbw: {algbw:.3f} GBps ({algbw * 8:.1f} Gbps)')
        print(f' busbw: {busbw:.3f} GBps ({busbw * 8:.1f} Gbps)')
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
