"""physher_tpu_torch.utils"""
