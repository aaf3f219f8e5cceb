"""ResNet training on NVIDIA cards: the PyTorch twin of
examples/train_resnet.py, on skypilot_tpu_torch.

The same flags (``--device`` in place of ``--platform``) and the same
printed lines; the step is ``skypilot_tpu_torch.train.tasks``'s (bf16
convolutions with f32 master weights and flax-style BatchNorm, Nesterov
SGD under a cosine decay).  examples/resnet.yaml runs on two nodes: under
torchrun (or the podlet's multi-process env) it runs data-parallel, one
process per card, with BatchNorm statistics over the global batch.

Examples:
  # one H100, the recipe's model and batch:
  python examples/train_resnet_torch.py --model resnet50 --batch-size 256

  # CPU smoke:
  python examples/train_resnet_torch.py --model resnet18-debug \\
      --device cpu --steps 30 --batch-size 16 --image-size 32 \\
      --num-classes 4
"""
import argparse

from skypilot_tpu_torch.train import tasks


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='resnet50')
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--batch-size', type=int, default=256)
    parser.add_argument('--image-size', type=int, default=32)
    parser.add_argument('--num-classes', type=int, default=10)
    parser.add_argument('--lr', type=float, default=0.1)
    parser.add_argument('--momentum', type=float, default=0.9)
    parser.add_argument('--data-dir', default=None,
                        help='CIFAR-10 pickle dir; default synthetic')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default=None, choices=['cuda', 'cpu'],
                        help='default: the CUDA card (raises without one)')
    args = parser.parse_args()
    tasks.train_resnet(model=args.model, steps=args.steps,
                       batch_size=args.batch_size,
                       image_size=args.image_size,
                       num_classes=args.num_classes, lr=args.lr,
                       momentum=args.momentum, data_dir=args.data_dir,
                       seed=args.seed, device=args.device)


if __name__ == '__main__':
    main()
