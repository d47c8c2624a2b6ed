"""Multi-host process-group setup.

The reference has no distribution at all (single OpenCL device,
SURVEY §2). For multi-host runs the framework uses JAX's standard
multi-controller model: every host runs the same program,
`jax.distributed.initialize` forms the process group (rendezvous via the
coordinator address), and the (rows, scene) mesh from parallel/mesh.py is
built over jax.devices() — which then spans all hosts, with XLA (NCCL on
GPUs) carrying the collectives.

Fail-fast policy (SURVEY §5 failure detection): initialization errors
raise immediately; set a rendezvous timeout rather than hanging forever.
"""

from __future__ import annotations

import os

import jax


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None,
                     process_id: int = None,
                     initialization_timeout: int = 300) -> dict:
    """Initialize the multi-host process group (idempotent).

    With no arguments, relies on what the cluster environment tells JAX
    (JAX_COORDINATOR_ADDRESS etc.); where nothing does, pass
    coordinator_address (e.g. "localhost:<port>"), num_processes and
    process_id. Returns a topology summary dict.
    """
    # jax 0.9 moved global_state out of the public module; the public
    # probe for "process group already formed" is is_initialized()
    # (the old jax.distributed.global_state access raised
    # AttributeError here — caught by the mocked multihost tests)
    if not jax.distributed.is_initialized():
        kwargs = {}
        if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
            kwargs["coordinator_address"] = (
                coordinator_address
                or os.environ["JAX_COORDINATOR_ADDRESS"])
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        jax.distributed.initialize(
            initialization_timeout=initialization_timeout, **kwargs)
    return topology_summary()


def topology_summary() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
