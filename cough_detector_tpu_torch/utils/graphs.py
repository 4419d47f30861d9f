"""Fixed-shape programs captured as CUDA graphs: the port's `jax.jit`.

The JAX package compiles its hot loops into programs of fixed shape: the
streaming tick (`jax.jit(stream_step)`) and the training epoch (one scanned
program). On a CUDA card the counterpart is a captured graph, replayed
with static input and output buffers. `Programs` keeps one graph a key, for
one path (the tick of one detector, the steps of one training run):

  * the first call of a key runs the function on a side stream (the call's
    own work, which also builds every cached constant and library handle
    the function touches), then captures it with `torch.cuda.graph` into
    the path's one memory pool, with the path's `torch.Generator`s
    registered, so a replay draws from each generator's current seed and
    offset exactly what the eager call draws;
  * every call copies its inputs into the key's static input buffers:
    host arrays through a ring of pinned staging buffers (`non_blocking`,
    each guarded by an event so the host never rewrites one while its copy
    is in flight), device tensors by a device copy;
  * a replay's outputs are copied out of the static outputs, so a result
    outlives the next replay;
  * the front-end kernel wrappers count a launch when Python calls them,
    which a replay does not: each graph records the launches it captured
    and adds them to the counters on every replay;
  * a capture that fails raises with the key and the cause; nothing runs
    the function eagerly instead.

On the CPU the same object copies the inputs into the same static buffers
and calls the function on them, so the buffer plumbing runs in the CPU
tests too. Graphs must not be captured from two threads at once.

Around the programs: `upload` puts a whole run of steps' host inputs on the
card in one copy (the pipelined epochs' matrices, JAX's `put_mats`),
`fetch` brings results back on a side stream without waiting for work
enqueued after them, and the scoring paths (offline batches, the
detector's `scores_for`, `predict`, evaluate, featurize) share one memory
pool a device (`scoring_pool`) and pad their batches to a bounded set of
shapes (`bucket_rows`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

Outputs = Tuple[torch.Tensor, ...]

# Pinned staging buffers an input: how many calls the host may run ahead of
# the card's copies before it waits for the oldest.
STAGING_DEPTH = 4

# The smallest batch a scoring path pads to (bucket_rows).
MIN_BUCKET = 16


def _launches() -> Tuple[int, ...]:
    from ..ops import frontend_kernel

    names = frontend_kernel.LAUNCH_COUNTERS + frontend_kernel.PLAN_COUNTERS
    return tuple(getattr(frontend_kernel, name) for name in names)


def _add_launches(counts: Sequence[int]) -> None:
    from ..ops import frontend_kernel

    for name, n in zip(frontend_kernel.LAUNCH_COUNTERS + frontend_kernel.PLAN_COUNTERS, counts):
        setattr(frontend_kernel, name, getattr(frontend_kernel, name) + n)


class _Staging:
    """A ring of pinned host buffers for one static input, each reused only
    after the copy out of it has run."""

    def __init__(self, like: torch.Tensor, depth: int):
        self.slots = [torch.empty(like.shape, dtype=like.dtype, pin_memory=True) for _ in range(depth)]
        self.copied = [None] * depth
        self.at = 0

    def put(self, static: torch.Tensor, array: np.ndarray) -> None:
        i = self.at
        self.at = (i + 1) % len(self.slots)
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        host = self.slots[i]
        np.copyto(host.numpy(), array, casting="no")
        static.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(static.device))
        self.copied[i] = event


class _Program:
    def __init__(self, static: Dict[str, torch.Tensor]):
        self.static = static
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Outputs = ()
        self.captured: Tuple[int, ...] = ()
        self.replays = 0


class Programs:
    """One path's programs, a graph a key on the card (see the module
    docstring). `generators`: the device generators the functions draw
    from; `name` names the path in errors; `pool`: the memory pool the
    graphs capture into (`scoring_pool`), one of the path's own by
    default."""

    def __init__(
        self,
        device: Union[str, torch.device],
        *,
        generators: Sequence[torch.Generator] = (),
        name: str = "program",
        pool: Optional[tuple] = None,
    ):
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self.generators = tuple(generators)
        self.name = name
        self._programs: Dict[Hashable, _Program] = {}
        self._inputs: Dict[tuple, torch.Tensor] = {}
        self._staging: Dict[tuple, _Staging] = {}
        if self.graphed:
            self._pool = pool if pool is not None else torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    @property
    def keys(self) -> list:
        """The keys seen so far, in the order of their first call."""
        return [k for k, _ in list(self._programs.items())]

    def launches(self) -> Dict[Hashable, Tuple[int, ...]]:
        """Each graph's front-end launches over its replays, a count a
        counter (frontend_kernel.LAUNCH_COUNTERS, then PLAN_COUNTERS):
        captured times replays.
        A key's first call launches eagerly and is not among them."""
        return {k: tuple(n * p.replays for n in p.captured) for k, p in list(self._programs.items())}

    def replays(self) -> Dict[Hashable, int]:
        """Each key's calls after its first (replays on the card)."""
        return {k: p.replays for k, p in list(self._programs.items())}

    def __call__(
        self,
        key: Hashable,
        fn: Callable[[Dict[str, torch.Tensor]], Outputs],
        inputs: Mapping[str, Union[np.ndarray, torch.Tensor]],
        copy: Optional[Sequence[bool]] = None,
    ) -> Outputs:
        """fn(static inputs) → a tuple of tensors, run as the key's program.
        `inputs` maps names to host arrays or tensors; every call of a key
        passes the same names, shapes and dtypes. Returns the outputs,
        each copied out unless `copy` says False for it (the static output
        itself, valid until the next call of the path)."""
        static = {name: self._put(name, value) for name, value in inputs.items()}
        prog = self._programs.get(key)
        if prog is None:  # kept once its first call (and capture) succeeded
            prog = _Program(static)
            first = self._capture(key, prog, fn) if self.graphed else tuple(fn(static))
            self._programs[key] = prog
            return first
        if static.keys() != prog.static.keys() or any(static[k] is not prog.static[k] for k in static):
            raise ValueError(f"{self.name} program {key!r}: inputs {sorted(static)} differ from its first call's")
        if self.graphed:
            prog.graph.replay()
            _add_launches(prog.captured)
            out = prog.outputs
        else:
            out = tuple(fn(prog.static))
        prog.replays += 1
        return tuple(o.clone() if copy is None or copy[i] else o for i, o in enumerate(out))

    def _put(self, name: str, value: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        on_device = isinstance(value, torch.Tensor) and value.device.type != "cpu"
        if not on_device:
            value = np.ascontiguousarray(value.numpy() if isinstance(value, torch.Tensor) else value)
        dtype = value.dtype if on_device else torch.from_numpy(value).dtype
        k = (name, tuple(value.shape), dtype)
        static = self._inputs.get(k)
        if static is None:
            static = self._inputs[k] = torch.empty(value.shape, dtype=dtype, device=self.device)
        if on_device:
            static.copy_(value)
        elif self.graphed:
            staging = self._staging.get(k)
            if staging is None:
                staging = self._staging[k] = _Staging(static, STAGING_DEPTH)
            staging.put(static, value)
        else:
            static.copy_(torch.from_numpy(value))
        return static

    def _capture(self, key: Hashable, prog: _Program, fn) -> Outputs:
        """The key's first call on the card: the call itself on the side
        stream, then its capture. Returns the call's outputs."""
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            first = tuple(fn(prog.static))
        main.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = _launches()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream, capture_error_mode="thread_local"):
                outputs = tuple(fn(prog.static))
        except Exception as err:
            raise RuntimeError(f"capturing the {self.name} program {key!r} failed: {err}") from err
        finally:
            captured = tuple(a - b for a, b in zip(_launches(), before))
            _add_launches(tuple(-n for n in captured))
        prog.graph, prog.outputs, prog.captured = graph, outputs, captured
        return first


_scoring_pools: Dict[torch.device, tuple] = {}


def scoring_pool(device: Union[str, torch.device]) -> Optional[tuple]:
    """The one memory pool every scoring path of the process captures into
    on `device` (None off the card). The scoring graphs run one after
    another on the caller's stream, so their intermediates may share
    memory: a batch's activations (about 1.2 GB for the residual model at
    1024 windows in FP32) are held once, not once a path."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _scoring_pools:
        _scoring_pools[dev] = torch.cuda.graph_pool_handle()
    return _scoring_pools[dev]


def bucket_rows(n: int, cap: Optional[int] = None) -> int:
    """The rows a scoring batch of n pads to: the next power of two, at
    least MIN_BUCKET, at most `cap` (when given, n <= cap). A graph a
    shape: this keeps a process that scores batches of many sizes (short
    recordings, segment candidates, a sweep's last chunk) to a few graphs.
    Scores are per row (BatchNorm in eval mode), so padded rows change no
    real row."""
    rows = max(MIN_BUCKET, 1 << max(n - 1, 0).bit_length())
    return rows if cap is None else min(rows, cap)


def pad_rows(x: Union[np.ndarray, torch.Tensor], rows: int) -> Union[np.ndarray, torch.Tensor]:
    """`x` zero-padded along its first axis to `rows`."""
    extra = rows - x.shape[0]
    if extra <= 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])
    return np.pad(x, [(0, extra)] + [(0, 0)] * (x.ndim - 1))


def upload(steps: Sequence[Mapping[str, np.ndarray]], device: Union[str, torch.device]) -> List[Dict[str, torch.Tensor]]:
    """A run of steps' host inputs on `device` in one copy: every array
    packed into one byte buffer (pinned on the card), uploaded without
    blocking, each step's inputs handed back as typed views of the device
    buffer. `Programs` copies a device tensor into its static input on the
    device, so the host never waits on this upload or on a staging buffer:
    it may enqueue the whole run, an epoch ahead of the card."""
    dev = torch.device(device)
    arrays = [[(name, np.ascontiguousarray(a)) for name, a in inputs.items()] for inputs in steps]
    offsets, at = [], 0
    for step in arrays:
        offsets.append([])
        for _, a in step:
            at = -(-at // 8) * 8  # every view aligned for an 8-byte dtype
            offsets[-1].append(at)
            at += a.nbytes
    host = torch.empty(at, dtype=torch.uint8, pin_memory=dev.type == "cuda")
    view = host.numpy()
    for step, offs in zip(arrays, offsets):
        for (_, a), off in zip(step, offs):
            view[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(dev, non_blocking=True)
    return [
        {
            name: buf[off : off + a.nbytes].view(torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
            for (name, a), off in zip(step, offs)
        }
        for step, offs in zip(arrays, offsets)
    ]


def fetch(tree: Any, after: Optional["torch.cuda.Event"]) -> Any:
    """`tree` (nested dicts, lists and tuples) with its card tensors copied
    to pinned host memory on a side stream that waits only on `after`, an
    event recorded once they were computed: work the compute stream
    enqueued later (the next epoch) runs on while they copy, where a
    `.cpu()` would wait for it. Returns once the copies have landed. Off
    the card (or with no event) the tree comes back as it is."""
    leaves, spec = pytree.tree_flatten(tree)
    cards = [i for i, t in enumerate(leaves) if isinstance(t, torch.Tensor) and t.device.type == "cuda"]
    if not cards or after is None:
        return tree
    stream = torch.cuda.Stream(leaves[cards[0]].device)
    stream.wait_event(after)
    with torch.cuda.stream(stream):
        for i in cards:
            host = torch.empty(leaves[i].shape, dtype=leaves[i].dtype, pin_memory=True)
            host.copy_(leaves[i], non_blocking=True)
            leaves[i] = host
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return pytree.tree_unflatten(leaves, spec)
