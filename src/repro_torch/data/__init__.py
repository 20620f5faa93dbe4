from repro_torch.data.synthetic import batch_for_step

__all__ = ["batch_for_step"]
