"""Finetune Llama-3.1-8B from a HuggingFace checkpoint on NVIDIA cards
with the port's trainer: the PyTorch twin of the ``run:`` body of
examples/finetune_llama31.yaml, on skypilot_tpu_torch.

The same environment: HF_MODEL_DIR (the checkpoint directory; the config
comes from its config.json alone, and the weights are read only on a
fresh run, by rank 0), CHECKPOINT_DIR (the latest checkpoint there is
resumed, so a managed-job recovery continues mid-run, on any mesh),
STEPS, and LORA_RANK (> 0: LoRA, the base frozen with no optimizer state
for it; 0: a full finetune).  The mesh is FSDP over every rank of the
process group, started from torchrun's env (or the podlet's; a plain
``python`` run is one rank on one card).  The recipe's batch of 64 x 8192
in 4 accumulated micro-steps is the default; the flags shrink it for a
smoke run.  The tokens are the trainer's synthetic stream, as the YAML's
body trains on; a resumed run continues that stream where its checkpoint
left it, so a run stopped and resumed equals one that ran straight.

Examples:
  # eight H100s of one host, the recipe's run:
  HF_MODEL_DIR=/hf/llama-3.1-8b CHECKPOINT_DIR=/ckpt/ft-llama31 \\
  STEPS=1000 LORA_RANK=16 torchrun --nproc-per-node 8 \\
      examples/finetune_llama31_torch.py

  # CPU smoke over two gloo ranks on a small checkpoint:
  HF_MODEL_DIR=/tmp/tiny-llama CHECKPOINT_DIR=/tmp/ft STEPS=4 \\
  LORA_RANK=4 torchrun --nproc-per-node 2 \\
      examples/finetune_llama31_torch.py --device cpu --batch-size 4 \\
      --seq-len 64 --grad-accum 2 --checkpoint-every 1
"""
import argparse
import dataclasses
import os


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default=None, choices=['cuda', 'cpu'],
                        help='default: the CUDA cards (raises without '
                             'one); cpu runs the ranks over gloo')
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--seq-len', type=int, default=8192)
    parser.add_argument('--grad-accum', type=int, default=4)
    parser.add_argument('--checkpoint-every', type=int, default=500)
    args = parser.parse_args()

    import transformers
    from torch import distributed as dist

    from skypilot_tpu_torch.models import hf_import
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import lora
    from skypilot_tpu_torch.train import trainer as trainer_lib

    device = mesh_lib.ensure_process_group(args.device)
    hf_dir = os.environ['HF_MODEL_DIR']
    # Config from config.json alone: the (16 GB+) weight load happens
    # only on a fresh run, never on a preemption recovery.
    cfg = hf_import.config_from_hf(
        transformers.AutoConfig.from_pretrained(hf_dir), name=hf_dir)
    lora_rank = int(os.environ.get('LORA_RANK', '0'))
    if lora_rank:
        cfg = dataclasses.replace(cfg, lora_rank=lora_rank)
    total_steps = int(os.environ['STEPS'])
    tcfg = trainer_lib.TrainConfig(
        model=cfg.name, batch_size=args.batch_size, seq_len=args.seq_len,
        grad_accum_steps=args.grad_accum,
        learning_rate=1e-4 if lora_rank else 1e-5,
        total_steps=total_steps,
        mesh=mesh_lib.MeshSpec.auto(dist.get_world_size()),
        checkpoint_dir=os.environ['CHECKPOINT_DIR'],
        checkpoint_every=args.checkpoint_every)
    trainer = trainer_lib.Trainer(tcfg, model_config=cfg, device=device)
    trainer.setup()   # restores the latest checkpoint if one exists
    start = int(trainer.state.step)
    if start == 0:
        # Fresh run: graft the converted HF weights in (by name, so the
        # LoRA model's adapters keep their zero-delta init); rank 0 reads
        # them and the graft sends every rank its shards.
        params = (hf_import.load_hf_model(hf_dir)[1]
                  if dist.get_rank() == 0 else {})
        lora.merge_base_params(trainer.state.model, params)
        del params
    remaining = total_steps - start
    if remaining <= 0:
        print('already finished at step', start)
        return trainer
    data = trainer_lib.synthetic_data(tcfg.batch_size, tcfg.seq_len,
                                      cfg.vocab_size, device=device)
    for _ in range(start):   # the batches the checkpoint has seen
        next(data)
    print(trainer.train(data, num_steps=remaining))
    return trainer


if __name__ == '__main__':
    main()
