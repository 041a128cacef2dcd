"""physher_tpu_torch.inference"""
