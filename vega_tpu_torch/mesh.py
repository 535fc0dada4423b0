"""The shard model: n global shards held as the leading dimension of every
column tensor, on one device or spread over the processes of a
torch.distributed group. Counterpart of vega_tpu/tpu/mesh.py (make_mesh,
shard_spec, init_multihost / ensure_multihost, host_get / host_put).

One process: every shard is a row of each [n_shards, capacity] tensor on
one device. Where the reference places shard s on mesh device s, the port
places it in row s, so both packages place rows shard for shard.

Several processes (Context(multihost=...)): n_shards stays the GLOBAL
shard count and must divide by the process count. Rank r holds global
shards [r * n_local, (r + 1) * n_local) as the rows of [n_local, capacity]
tensors on its own device, so a run at world size 2 places every row on
the same global shard as a run at world size 1 with the same n_shards,
and as the reference's global mesh, where process 0's devices come first.
Every process runs the same program (SPMD), and these helpers are
its only collectives:

  host_get(mesh, tensors)  per-shard tensors gathered to [n_shards, ...]
                           on every rank in ONE all_gather, read with one
                           .cpu(): every process sees the same counts and
                           flags and so takes the same branch next;
  host_put(mesh, array)    the rank's rows of a host array that every
                           rank holds identically;
  replicate(mesh, t)       an all_gather that leaves [n_shards, ...] on the
                           device (the cartesian's right side);
  exchange_shards(mesh, b) the all-to-all of [n_local, n_shards, ...] send
                           buffers with equal splits;
  exchange_rows(...)       all_to_all_single with uneven splits (a ring
                           round's peers);
  all_reduce(mesh, t, op)  sum / min / max over ranks (the table plan);
  agree_objects(mesh, obj) process 0's host object on every rank (a host
                           RDD's rows that dense() lifts).

Only collectives that NCCL and gloo both take: all_gather,
all_to_all_single and all_reduce. A collective that cannot complete (a
lost peer, or one that never reaches it within heartbeat_timeout_s, the
group's timeout) raises CollectiveError (a VegaError) naming the timeout,
where the reference's jax coordination service terminates the survivors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
from typing import List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from vega_tpu_torch.errors import CollectiveError, VegaError

# jax.distributed.initialize's heartbeat_timeout_seconds default, which the
# reference records as the effective timeout when none is passed
DEFAULT_HEARTBEAT_S = 100


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device a Context runs on: the one given, else the first CUDA
    card. With no card and no device given this raises: the port never
    runs on the CPU unless the caller asks for it."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise VegaError(f"device {dev} requested but CUDA is not "
                            "available")
        return dev
    if not torch.cuda.is_available():
        raise VegaError("no CUDA device available; pass device='cpu' to "
                        "run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """n_shards global shards; this process holds n_local of them, from
    global shard first_shard on. group is the torch.distributed process
    group of a multi-process mesh (None: one device, no collectives)."""

    n_shards: int
    device: torch.device
    rank: int = 0
    world: int = 1
    group: Optional[object] = dataclasses.field(default=None,
                                                compare=False)
    timeout_s: Optional[int] = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise VegaError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_shards % self.world:
            raise VegaError(
                f"n_shards={self.n_shards} must divide by the number of "
                f"processes ({self.world}): each holds n_shards / "
                "num_processes global shards")

    @property
    def n_local(self) -> int:
        return self.n_shards // self.world

    @property
    def first_shard(self) -> int:
        return self.rank * self.n_local

    @property
    def collective(self) -> bool:
        """True when shard data crosses processes through the group (also
        at world size 1 when a group was joined)."""
        return self.group is not None

    def shard_ids(self) -> torch.Tensor:
        """int64[n_local]: the global ids of this process's shards."""
        return torch.arange(self.first_shard, self.first_shard
                            + self.n_local, device=self.device)

    def local(self, arr: np.ndarray) -> np.ndarray:
        """This process's rows of a host array over the global shards."""
        return arr[self.first_shard:self.first_shard + self.n_local]


def make_mesh(n_shards: int, device=None, multihost: bool = False
              ) -> ShardMesh:
    """A one-process mesh; with multihost, this process's part of the
    mesh over the group init_multihost joined."""
    if not multihost:
        return ShardMesh(n_shards, resolve_device(device))
    if _multihost_settings is None:
        raise VegaError("no torch.distributed group joined: call "
                        "ensure_multihost first")
    _, world, rank = _multihost_settings
    return ShardMesh(n_shards, resolve_device(device), rank=rank,
                     world=world, group=dist.group.WORLD,
                     timeout_s=_multihost_heartbeat_s)


# ---------------------------------------------------------------------------
# joining a process group: the reference's init_multihost / ensure_multihost
# ---------------------------------------------------------------------------

_multihost_settings: Optional[tuple] = None  # set once per process
_multihost_heartbeat_s: Optional[int] = None  # the timeout actually applied
_multihost_backend: Optional[str] = None


def _normalize_multihost(coordinator, num_processes, process_id) -> tuple:
    """Apply the env-var defaults (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID: the reference's names, read as
    plain strings) so equivalent settings compare equal whether they came
    explicit or from the environment."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = os.environ["JAX_NUM_PROCESSES"]
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = os.environ["JAX_PROCESS_ID"]
    return (coordinator,
            None if num_processes is None else int(num_processes),
            None if process_id is None else int(process_id))


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   heartbeat_timeout_s: Optional[int] = None,
                   backend: Optional[str] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> None:
    """Join this process to a torch.distributed process group: every
    process runs the same program, and each later Context spans
    all of them (n_shards global, n_local per process). coordinator is
    "host:port" of rank 0's rendezvous store; the settings default from
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID.

    backend defaults to nccl for a CUDA device and gloo for the CPU (the
    device given, else the first card when one exists); backend= only
    overrides it. heartbeat_timeout_s (default 100 s, jax's) is the
    group's timeout: a survivor whose collective cannot complete (a peer
    died) raises VegaError within it, and the process exits non-zero
    instead of hanging. NCCL needs its asynchronous error handling for
    that, which this turns on unless the environment sets it."""
    global _multihost_settings, _multihost_heartbeat_s, _multihost_backend
    coordinator, num_processes, process_id = _normalize_multihost(
        coordinator, num_processes, process_id)
    if not coordinator or num_processes is None or process_id is None:
        raise VegaError(
            "multihost needs coordinator ('host:port'), num_processes and "
            "process_id (or JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
            f"JAX_PROCESS_ID); got {(coordinator, num_processes, process_id)}")
    if not 0 <= process_id < num_processes:
        raise VegaError(f"process_id {process_id} outside [0, "
                        f"{num_processes})")
    timeout = (DEFAULT_HEARTBEAT_S if heartbeat_timeout_s is None
               else int(heartbeat_timeout_s))
    if backend is None:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    if dist.is_initialized():
        raise VegaError("torch.distributed is already initialized in this "
                        "process outside vega_tpu_torch; a Context cannot "
                        "join a second group")
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    _multihost_settings = (coordinator, num_processes, process_id)
    _multihost_heartbeat_s = timeout
    _multihost_backend = backend


def ensure_multihost(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     heartbeat_timeout_s: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> None:
    """Idempotent init_multihost: a process may build several successive
    Contexts (stop() then a new one) on the same group, which stays up.
    A different rendezvous, heartbeat timeout or backend than the one
    this process joined cannot be honored and raises VegaError."""
    if _multihost_settings is None:
        init_multihost(coordinator, num_processes, process_id,
                       heartbeat_timeout_s=heartbeat_timeout_s,
                       backend=backend, device=device)
        return
    requested = _normalize_multihost(coordinator, num_processes, process_id)
    if requested != _multihost_settings:
        raise VegaError(
            "this process already joined a torch.distributed group with "
            f"settings {_multihost_settings}; a Context requesting "
            f"{requested} cannot re-rendezvous (a process joins one group)")
    if heartbeat_timeout_s is not None \
            and int(heartbeat_timeout_s) != _multihost_heartbeat_s:
        raise VegaError(
            "this process already joined its torch.distributed group with "
            f"heartbeat_timeout_s={_multihost_heartbeat_s}; requesting "
            f"{heartbeat_timeout_s} cannot be honored (the group's timeout "
            "is set once per process)")
    if backend is not None and backend != _multihost_backend:
        raise VegaError(
            f"this process already joined its group over "
            f"{_multihost_backend!r}; requesting backend {backend!r} cannot "
            "be honored")


def multihost_backend() -> Optional[str]:
    return _multihost_backend


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# Process-wide counts for measurement: host_get calls (any mesh), and per
# collective its calls and the bytes this process sends to other processes
# (an all_reduce counted as its tensor once per peer); agree_objects' calls
# and the pickled bytes it carried.
WIRE = {"host_get": 0, "all_gather": 0, "all_to_all_single": 0,
        "all_reduce": 0, "bytes_sent": 0, "agree": 0, "agree_bytes": 0}


def _collective(mesh: ShardMesh, what: str, fn):
    """Run one collective; a failure (a lost peer, a timeout) becomes a
    CollectiveError (a VegaError) that names the group's timeout, so the
    survivor fails crisply."""
    WIRE[what] += 1
    try:
        return fn()
    except RuntimeError as e:  # torch.distributed.DistBackendError et al.
        raise CollectiveError(
            f"{what} across {mesh.world} processes failed (rank "
            f"{mesh.rank}): a peer process is lost or did not reach the "
            f"collective within heartbeat_timeout_s={mesh.timeout_s}: "
            f"{e}") from e


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the wire carries it: bool as uint8, contiguous."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(torch.bool) if dtype == torch.bool else t


def _gather(mesh: ShardMesh, t: torch.Tensor) -> torch.Tensor:
    """all_gather of each rank's [n_local, ...] tensor into [n_shards, ...]
    on the device, rank-major: global shard order."""
    w = _wire(t)
    WIRE["bytes_sent"] += w.numel() * w.element_size() * (mesh.world - 1)
    parts = [torch.empty_like(w) for _ in range(mesh.world)]
    _collective(mesh, "all_gather", lambda: dist.all_gather(
        parts, w, group=mesh.group))
    return _unwire(torch.cat(parts), t.dtype)


def host_get(mesh: ShardMesh, tensors):
    """Per-shard device tensors (leading dim n_local) as host numpy arrays
    over all n_shards (leading dim n_shards), the same on every rank. A
    list gives a list, one tensor one array. Without a group this is each
    tensor's .cpu() (a list packed into one transfer); with one, all the
    tensors travel as bytes in ONE all_gather and come back with one
    .cpu().

    The dense tier's stage-launch transfer itself: a DenseRDD
    materializes on its job's own driver thread by design (one device
    program per stage), so the round trip is that job's own work, bounded
    by device compute — it cannot park other tenants' scheduling."""
    WIRE["host_get"] += 1
    single = isinstance(tensors, torch.Tensor)
    ts = [tensors] if single else list(tensors)
    if not mesh.collective:
        if len(ts) == 1:
            # vegalint: ignore[VG016] — stage-launch transfer on the job's own drive thread (see above)
            out = [ts[0].cpu().numpy()]
        else:
            # vegalint: ignore[VG016] — stage-launch transfer on the job's own drive thread (see above)
            out = _split_bytes(_pack(ts).cpu(), ts, 1)
        return out[0] if single else out
    packed = _pack(ts)
    # vegalint: ignore[VG016] — stage-launch transfer on the job's own drive thread (see above)
    gathered = _gather(mesh, packed).cpu()
    out = _split_bytes(gathered, ts, mesh.world)
    return out[0] if single else out


def _pack(ts: List[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, each flattened, one after another."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in ts])


def _split_bytes(host: torch.Tensor, ts: List[torch.Tensor],
                 world: int) -> List[np.ndarray]:
    """Unpack `world` rank-major copies of _pack(ts) into one numpy array
    per tensor, its leading dim the ranks' leading dims concatenated."""
    per_rank = host.view(world, -1)
    out, offset = [], 0
    for t in ts:
        nb = t.numel() * t.element_size()
        # a fresh compact copy: a slice of one rank's row keeps the row's
        # stride and offset, which a view as a wider dtype refuses
        raw = per_rank[:, offset:offset + nb].clone(
            memory_format=torch.contiguous_format)
        arr = raw.view(t.dtype if t.dtype != torch.bool else torch.uint8)
        arr = arr.reshape((world * t.shape[0],) + tuple(t.shape[1:])) \
            if t.dim() else arr.reshape(world)
        arr = arr.numpy()
        out.append(arr.astype(np.bool_) if t.dtype == torch.bool else arr)
        offset += nb
    return out


def host_put(mesh: ShardMesh, value) -> torch.Tensor:
    """This rank's rows (global shards [first_shard, first_shard +
    n_local)) of a host array over all n_shards that every rank holds
    identically, on the device; without a group, the whole array."""
    arr = np.asarray(value)
    if mesh.world > 1:
        arr = mesh.local(arr)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)


def replicate(mesh: ShardMesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's [n_local, ...] tensor as one [n_shards, ...] tensor on
    each rank's device (an all_gather); without a group, t itself."""
    if not mesh.collective:
        return t
    return _gather(mesh, t)


def exchange_shards(mesh: ShardMesh, buf: torch.Tensor) -> torch.Tensor:
    """The all-to-all of send buffers: buf[i, t, ...] is what local shard
    i sends to global shard t; returns out[j, s, ...], what local shard j
    receives from global shard s. One all_to_all_single with equal splits
    of n_local * n_local slots per peer (static capacities make every
    split the same, as lax.all_to_all's are)."""
    n_local, world = mesh.n_local, mesh.world
    rest = tuple(buf.shape[2:])
    # [src_local, dst_rank, dst_local, ...] -> [dst_rank, dst_local,
    # src_local, ...]: each peer's chunk contiguous
    send = _wire(buf.view((n_local, world, n_local) + rest)
                 .transpose(0, 1).transpose(1, 2))
    WIRE["bytes_sent"] += send.numel() * send.element_size() \
        * (world - 1) // world
    recv = torch.empty_like(send)
    _collective(mesh, "all_to_all_single", lambda: dist.all_to_all_single(
        recv, send, group=mesh.group))
    recv = _unwire(recv, buf.dtype)
    # [src_rank, dst_local, src_local, ...] -> [dst_local, src_rank,
    # src_local, ...] = [dst_local, global src, ...]
    return recv.transpose(0, 1).reshape((n_local, world * n_local) + rest)


def exchange_rows(mesh: ShardMesh, send: torch.Tensor, in_splits,
                  out_splits) -> torch.Tensor:
    """all_to_all_single of send's dim-0 rows with per-peer split sizes
    (rows for peer r: in_splits[r]; rows from peer r: out_splits[r]): a
    ring or staged round sends only to that round's peers."""
    w = _wire(send)
    WIRE["bytes_sent"] += (sum(in_splits) - in_splits[mesh.rank]) \
        * (w[:1].numel() * w.element_size())
    recv = w.new_empty((int(sum(out_splits)),) + tuple(w.shape[1:]))
    _collective(mesh, "all_to_all_single", lambda: dist.all_to_all_single(
        recv, w, output_split_sizes=list(out_splits),
        input_split_sizes=list(in_splits), group=mesh.group))
    return _unwire(recv, send.dtype)


_REDUCE_OPS = {"add": "SUM", "min": "MIN", "max": "MAX"}


def all_reduce(mesh: ShardMesh, t: torch.Tensor, op: str) -> torch.Tensor:
    """t reduced over the ranks (add / min / max), in place; without a
    group, t itself."""
    if not mesh.collective:
        return t
    red = getattr(dist.ReduceOp, _REDUCE_OPS[op])
    WIRE["bytes_sent"] += t.numel() * t.element_size() * (mesh.world - 1)
    _collective(mesh, "all_reduce", lambda: dist.all_reduce(
        t, op=red, group=mesh.group))
    return t


def agree_objects(mesh: ShardMesh, obj):
    """Process 0's obj on every rank, so every rank goes on from the same
    host value (the ranks may have computed it apart, as two fleets'
    collects of one shuffle merge in different orders). Its pickle
    travels in two all_gathers on the calling thread: rank 0's length,
    then that many bytes from each rank, the others sending zeros. The
    ranks run one program and trust each other's pickles. Without a
    group, obj itself."""
    if not mesh.collective:
        return obj
    WIRE["agree"] += 1
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL) \
        if mesh.rank == 0 else b""
    size = torch.tensor([len(payload)], dtype=torch.int64,
                        device=mesh.device)
    size = int(_gather(mesh, size)[0].item())
    buf = torch.zeros(size, dtype=torch.uint8)
    if mesh.rank == 0:
        buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    got = _gather(mesh, buf.to(mesh.device))[:size].cpu()
    WIRE["agree_bytes"] += size
    return pickle.loads(got.numpy().tobytes())
