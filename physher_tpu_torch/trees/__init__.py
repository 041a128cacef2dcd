"""physher_tpu_torch.trees"""
