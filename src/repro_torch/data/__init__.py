"""Data of the port: the synthetic language-modelling stream."""
from repro_torch.data.synthetic import SyntheticBatchStream, SyntheticLMDataset, make_batches

__all__ = ["SyntheticBatchStream", "SyntheticLMDataset", "make_batches"]
