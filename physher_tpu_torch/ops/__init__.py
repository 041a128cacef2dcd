"""physher_tpu_torch.ops"""
