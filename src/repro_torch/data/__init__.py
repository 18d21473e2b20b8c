from repro_torch.data.synthetic import SyntheticTokens, make_batch

__all__ = ["SyntheticTokens", "make_batch"]
