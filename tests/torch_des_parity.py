"""Shared pieces of the DES parity tests (``test_torch_des.py``,
``test_torch_ycsb.py``, ``test_torch_serving_load.py``): one scenario is a
function of the package name, run once in the JAX package (``repro``) and
once in the port (``repro_torch``, its Erda clients verifying on the CPU),
and the two results are compared exactly, as reprs with the package prefix
normalised.

The port's plain CRC loops over bytes on the CPU (about 10 ms for a 64 B
record and 37 ms for 1 KiB, flat up to 16 rows), so the scenarios use small
values and few reads."""
import importlib

PKGS = ("repro", "repro_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def on_cpu(pkg: str, **kw) -> dict:
    """Keyword arguments for an entry point that builds a store: the port's
    runs on the CPU only when asked."""
    return dict(kw, device="cpu") if pkg == "repro_torch" else kw


def canon(obj) -> str:
    """The exact repr of a report or a trace, the package prefix aside."""
    return repr(obj).replace("repro_torch.", "repro.")


def assert_same(scenario, *args, **kwargs):
    """Run ``scenario(pkg, *args, **kwargs)`` in both packages and require
    equal reprs; returns the reference's result."""
    ref, port = (scenario(pkg, *args, **kwargs) for pkg in PKGS)
    assert canon(port) == canon(ref)
    return ref


def sim_factory(pkg: str, p=None):
    """A ``transport_factory`` of ``SimTransport``s at the default prices."""
    SimTransport = mod(pkg, "fabric.sim").SimTransport
    p = p or mod(pkg, "netsim.pricing").SimParams()
    return lambda dev: SimTransport(dev, p)


def server_config(pkg: str, **kw):
    return mod(pkg, "core").ServerConfig(**kw)


#: the DES capture geometry (``benchmarks/schemes_des.py``'s): traces depend
#: on verb sizes, not on the device's capacity
CAPTURE = dict(device_size=8 << 20, table_capacity=1 << 10, n_heads=1,
               region_size=1 << 20, segment_size=64 << 10)


def sim_store(pkg: str, scheme: str, p=None, **kw):
    """``scheme``'s store over ``SimTransport``: erda and erda-cluster at
    the capture geometry, the baselines at their capture sizes."""
    make_store = mod(pkg, "core").make_store
    factory = sim_factory(pkg, p)
    if scheme in ("erda", "erda-cluster"):
        return make_store(scheme, **on_cpu(pkg, cfg=server_config(pkg, **CAPTURE),
                                           transport_factory=factory, **kw))
    if scheme == "redo":
        return make_store("redo", **on_cpu(pkg, device_size=8 << 20,
                                           redo_capacity=1 << 20,
                                           transport_factory=factory))
    return make_store("raw", **on_cpu(pkg, device_size=8 << 20,
                                      ring_capacity=1 << 20,
                                      transport_factory=factory))


def transports(store) -> list:
    """Every ``SimTransport`` of a store, in lane order."""
    cluster = getattr(store, "cluster", None)
    if cluster is not None:
        return [c.transport for sid in sorted(cluster.groups.keys())
                for c in cluster.groups[sid].replicas]
    return [store.transport]


def take(store) -> list:
    """Drain and return every lane's (steps, doorbells)."""
    return [(t.take_steps(), t.take_doorbells()) for t in transports(store)]


def clear_loc_caches(store) -> None:
    """Drop the Erda clients' location hints, so the next read is cold."""
    client = getattr(store, "client", None)
    if client is not None:
        client.loc_cache.clear()
    cluster = getattr(store, "cluster", None)
    if cluster is not None:
        for g in cluster.groups:
            for c in g.replicas:
                c.loc_cache.clear()
