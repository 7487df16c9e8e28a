"""PICE's sketch fine-tuning (paper §IV-D) on the port: supervised
fine-tuning (`sft`), preference labels (`preference`), a Bradley-Terry
reward model (`reward_model`) and REINFORCE with a KL term to the SFT
policy (`rlaif`). `python -m repro_torch.finetune` runs the four in turn."""
