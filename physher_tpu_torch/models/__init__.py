"""physher_tpu_torch.models"""
