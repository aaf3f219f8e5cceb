"""BERT sequence-classification finetune (IMDB-style) on NVIDIA cards: the
PyTorch twin of examples/finetune_bert.py, on skypilot_tpu_torch.

The same flags (``--device`` in place of ``--platform``) and the same
printed lines; the step is ``skypilot_tpu_torch.train.tasks``'s (bf16
encoder with f32 master weights, AdamW with weight decay 0.01).  Under
torchrun (or the podlet's multi-process env) it runs data-parallel, one
process per card, each drawing its share of --batch-size.

Examples:
  # one H100, the recipe (examples/bert_imdb.yaml) on synthetic data:
  python examples/finetune_bert_torch.py --model bert-base --steps 50

  # two cards of one host:
  torchrun --nproc-per-node 2 examples/finetune_bert_torch.py \\
      --model bert-base --steps 50

  # CPU smoke:
  python examples/finetune_bert_torch.py --model bert-debug --device cpu \\
      --dataset synthetic --steps 30 --batch-size 8 --seq-len 64
"""
import argparse

from skypilot_tpu_torch.train import tasks


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='bert-base')
    parser.add_argument('--dataset', default='synthetic',
                        choices=['synthetic', 'imdb'])
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--seq-len', type=int, default=128)
    parser.add_argument('--lr', type=float, default=2e-5)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default=None, choices=['cuda', 'cpu'],
                        help='default: the CUDA card (raises without one)')
    args = parser.parse_args()
    tasks.finetune_bert(model=args.model, dataset=args.dataset,
                        steps=args.steps, batch_size=args.batch_size,
                        seq_len=args.seq_len, lr=args.lr, seed=args.seed,
                        device=args.device)


if __name__ == '__main__':
    main()
