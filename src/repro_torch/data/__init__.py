from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                       host_batch_iterator, make_global_batch)

__all__ = ["DataConfig", "SyntheticLMDataset", "host_batch_iterator",
           "make_global_batch"]
