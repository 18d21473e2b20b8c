"""Bytes the page store's NVM took in (``NVMStats.bytes_written``, summed
over its servers) per byte of page handed to it (snapshotted cache leaves
and token pages), outside the traced slice: Erda's write amplification."""


def read(r):
    pages = r.counters.get("page_bytes")
    return r.counters["nvm_bytes"] / pages if pages else None
