"""Llama training on NVIDIA cards with the port's trainer: the PyTorch twin
of examples/train_llama.py, on skypilot_tpu_torch.

The same flags (``--device`` added) and the same printed lines.  One
process runs per card: launch it with torchrun, or under the podlet,
whose env (SKYTPU_COORDINATOR_ADDRESS / SKYTPU_PROCESS_ID /
SKYTPU_NUM_PROCESSES) starts the process group the same way; a plain
``python`` run is one process, a one-rank mesh on one card.  The mesh
axes default to FSDP over every rank.

Checkpoint/resume contract: pass --checkpoint-dir at a MOUNTed bucket
path; managed-job recovery restores the latest step (the state is
gathered whole and rank 0 writes it, so a recovery may use another mesh).

Examples:
  # one H100, 1B model:
  python examples/train_llama_torch.py --model llama-1b --steps 200

  # eight cards of one host, FSDP, 8B model, long context:
  torchrun --nproc-per-node 8 examples/train_llama_torch.py \\
      --model llama3-8b --seq-len 8192 --batch-size 8 --fsdp 8

  # CPU smoke over two gloo ranks:
  torchrun --nproc-per-node 2 examples/train_llama_torch.py \\
      --model llama-debug --device cpu --steps 4 --batch-size 4 \\
      --seq-len 64
"""
import argparse

from torch import distributed as dist


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='llama-1b')
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--seq-len', type=int, default=2048)
    parser.add_argument('--lr', type=float, default=3e-4)
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--checkpoint-every', type=int, default=100)
    # Mesh axes; defaults to FSDP over all ranks.
    parser.add_argument('--data', type=int, default=1)
    parser.add_argument('--fsdp', type=int, default=0,
                        help='0 = all remaining ranks')
    parser.add_argument('--tensor', type=int, default=1)
    parser.add_argument('--seq', type=int, default=1)
    parser.add_argument('--device', default=None, choices=['cuda', 'cpu'],
                        help='default: the CUDA cards (raises without '
                             'one); cpu runs the ranks over gloo')
    args = parser.parse_args()

    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import trainer as trainer_lib

    device = mesh_lib.ensure_process_group(args.device)
    n = dist.get_world_size()
    fsdp = args.fsdp or n // (args.data * args.tensor * args.seq)
    spec = mesh_lib.MeshSpec(data=args.data, fsdp=fsdp,
                             tensor=args.tensor, seq=args.seq)
    cfg = trainer_lib.TrainConfig(
        model=args.model,
        batch_size=args.batch_size,
        seq_len=args.seq_len,
        learning_rate=args.lr,
        total_steps=args.steps,
        mesh=spec,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    trainer = trainer_lib.Trainer(cfg, device=device)
    trainer.setup()
    start = int(trainer.state.step)
    if start:
        print(f'resumed from checkpoint at step {start}')
    remaining = args.steps - start
    if remaining <= 0:
        # Recovery after the final checkpoint: nothing left to train.
        print(f'already at step {start} >= --steps {args.steps}; done')
        return
    metrics = trainer.train(num_steps=remaining)
    print(f"final loss {metrics['final_loss']:.4f}; "
          f"{metrics['tokens_per_second']:,.0f} tokens/s "
          f"({metrics['tokens_per_second_per_device']:,.0f} tok/s/chip)")
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
