"""physher_tpu_torch.likelihood"""
