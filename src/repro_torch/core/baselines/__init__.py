from repro_torch.core.baselines.redo_logging import RedoLoggingStore
from repro_torch.core.baselines.read_after_write import ReadAfterWriteStore

__all__ = ["RedoLoggingStore", "ReadAfterWriteStore"]
