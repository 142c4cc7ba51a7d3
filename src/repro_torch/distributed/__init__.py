"""repro_torch.distributed"""
