from repro_torch.checkpoint.io import latest_step, load_checkpoint, save_checkpoint
