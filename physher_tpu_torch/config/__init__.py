"""physher_tpu_torch.config"""
