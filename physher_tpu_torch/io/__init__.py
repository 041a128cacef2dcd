"""physher_tpu_torch.io"""
