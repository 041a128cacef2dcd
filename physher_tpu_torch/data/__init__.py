"""physher_tpu_torch.data"""
