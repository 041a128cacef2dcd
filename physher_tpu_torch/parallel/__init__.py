"""physher_tpu_torch.parallel"""
