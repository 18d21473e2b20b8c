from repro_torch.roofline.analysis import (collective_bytes, roofline_terms,
                                           RooflineReport)

__all__ = ["collective_bytes", "roofline_terms", "RooflineReport"]
