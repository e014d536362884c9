"""Shared runtime set-up for the entry points: platform, compile cache,
multi-process launch.

Every long-running CLI takes ``--platform`` (like the scripts/ entry
points) and applies it through ``jax.config``, which still wins as long as
no backend has been initialized, so a run can be pinned to the CPU without
touching the environment.
"""

from __future__ import annotations

import os

# A fixed path, so that every process of this checkout finds what the others
# compiled: never derived from a temp name, a pid or the time.
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
COMPILE_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Keep compiled programs across processes; returns the cache directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and no
    other cache is configured.  Otherwise the cache is the checkout's
    ``.jax_cache/``.  Call before the first compilation of the process.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR


def device_record() -> dict:
    """Where a measurement ran: JAX's platform, device kind and device
    count, and on a GPU the card's name and power limit as nvidia-smi
    reports them (a card set below its maximum runs slower under load)."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    out = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    if dev.platform == "gpu":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    return out


def add_platform_flag(parser) -> None:
    parser.add_argument(
        "--platform", default=None,
        help="jax platform override (e.g. 'cpu', 'gpu'); applied via "
             "jax.config before first device use.",
    )


def apply_platform(args) -> None:
    """Apply ``--platform`` and turn on the compile cache."""
    if getattr(args, "platform", None):
        import jax

        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()


def add_distributed_flags(parser) -> None:
    """Multi-process launch flags shared by the multi-host entry points
    (cunvsm-train, rank_adhoc, e2e_throughput)."""
    parser.add_argument(
        "--distributed", action="store_true",
        help="Multi-process (multi-host) run: join the global device set "
             "via jax.distributed cluster auto-detection (e.g. SLURM) "
             "before any backend use.  For manual launches pass the "
             "--coordinator_address/--num_processes/--process_id triple "
             "instead.  One process per host drives all of that host's "
             "cards.",
    )
    parser.add_argument(
        "--coordinator_address", default=None,
        help="host:port of process 0's coordinator (manual multi-process "
             "launch; implies --distributed).",
    )
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def apply_distributed(args) -> None:
    """Join the global device set if requested.  Call AFTER apply_platform
    (the platform override must be in place) and before any backend use."""
    if getattr(args, "distributed", False) or (
        getattr(args, "coordinator_address", None) is not None
    ):
        from cunvsm.parallel.distributed import initialize

        initialize(
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
