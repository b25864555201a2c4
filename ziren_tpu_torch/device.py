"""The port's devices: the CUDA check, the resolution of a device name, and
the mesh that the multi-device layer (stark/ici.py, stark/sharded.py and
stark.machine.prove(devices=...)) runs on, the counterpart of
jax.sharding.Mesh.

A mesh is an ordered list of members on one named axis. A member is a
torch device and, on CUDA, a stream of its own: its work is ordered on that
stream and overlaps the other members'. Several members may name the same
card, as the JAX package's tests run an 8-device mesh on one host; members
on distinct cards exchange tensors by peer copies. A mesh of CPU members
exists only when the caller names "cpu", as the tests do: it runs the same
code one member after the other, and the mesh with no devices named is one
member per visible card, which raises without CUDA.

Ordering between members: a tensor that one member's stream made is handed
to another by `send`, which makes the receiving stream wait for the sending
one and records the tensor on the stream that reads it, so that the caching
allocator does not reuse its memory while that read is pending.
"""

from __future__ import annotations

import contextlib

import torch


def require_cuda() -> torch.device:
    """The current CUDA device; raises when PyTorch sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("ziren_tpu_torch: CUDA is not available")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """None is the current CUDA device, and raises without one."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"ziren_tpu_torch: no device {dev}")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"ziren_tpu_torch: unsupported device {dev}")
    return dev


def prover_device(device=None, *, host: bool = True):
    """A prover's device resolved before any work, as the drivers and
    machine.mips.prove_program_checkpointed take it: "host" (the numpy
    prover) as given, or refused where `host` is false (a driver that times
    the torch prover's legs), anything else as resolve_device has it, so a
    caller left without a device fails at once where there is no card."""
    if device != "host":
        return resolve_device(device)
    if not host:
        raise ValueError("the legs are the torch prover's: pass cpu or a CUDA device, "
                         "or leave --device out for the GPU")
    return "host"


def synchronize(device) -> None:
    """Wait for the device's work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    """What a driver prints of where it proves: the card's name, or the
    device's own ("cpu", "host")."""
    if isinstance(device, torch.device) and device.type == "cuda":
        return f"{device} {torch.cuda.get_device_name(device)}"
    return str(device)


class Member:
    """One member of a mesh: its place on the axis, its device and its
    stream. A stream of None is the caller's current stream (every CPU
    member; a CUDA device proved on without a mesh)."""

    __slots__ = ("index", "device", "stream")

    def __init__(self, index: int, device: torch.device, stream=None):
        self.index, self.device, self.stream = index, device, stream

    def scope(self):
        """The context in which this member's work is issued: on CUDA its
        device and stream are the current ones."""
        return contextlib.nullcontext() if self.stream is None else torch.cuda.stream(self.stream)


def caller(x: torch.Tensor) -> Member:
    """The caller of a mesh function, as the member that owns `x`: x's
    device, and on CUDA the current stream there."""
    stream = torch.cuda.current_stream(x.device) if x.is_cuda else None
    return Member(-1, x.device, stream)


class Mesh:
    """An ordered list of members on one named axis. `devices` names each
    member's device ("cuda:0" four times is four members on one card, each
    with its own stream; "cpu" eight times is the tests' mesh); all members
    are CUDA or all are CPU."""

    def __init__(self, devices, axis: str = "row"):
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("ziren_tpu_torch: a mesh needs at least one member")
        if len({d.type for d in devs}) != 1:
            raise ValueError("ziren_tpu_torch: a mesh's members are all CUDA or all CPU")
        self.axis = axis
        self.members = tuple(
            Member(i, d, torch.cuda.Stream(d) if d.type == "cuda" else None)
            for i, d in enumerate(devs))

    @classmethod
    def default(cls, axis: str = "row") -> "Mesh":
        """One member per visible CUDA card; raises without CUDA."""
        require_cuda()
        return cls([torch.device("cuda", i) for i in range(torch.cuda.device_count())], axis)

    def check_axis(self, axis: str) -> None:
        if axis != self.axis:
            raise ValueError(f"ziren_tpu_torch: the mesh's axis is {self.axis!r}, not {axis!r}")

    def __len__(self) -> int:
        return len(self.members)

    def __iter__(self):
        return iter(self.members)

    def __getitem__(self, i: int) -> Member:
        return self.members[i]

    def __repr__(self) -> str:
        return f"Mesh({[str(m.device) for m in self.members]}, axis={self.axis!r})"


def send(x: torch.Tensor, src: Member, dst: Member) -> torch.Tensor:
    """x, which src's stream made (or, for the caller, which the caller's
    current stream may read), as a tensor that dst's stream may read: x
    itself on a shared card, once dst's stream waits for src's; a peer copy
    on src's stream otherwise, which dst's stream waits for; a plain copy
    from or to the host."""
    if x.device.type == "cpu" or dst.device.type == "cpu":
        # to or from the host: on the card's side's stream, which the copy
        # waits for
        with dst.scope() if x.device.type == "cpu" else src.scope():
            return x.to(dst.device)
    if x.device == dst.device:
        dst.stream.wait_stream(src.stream)
        x.record_stream(dst.stream)
        return x
    # torch copies between cards on the source card's current stream, after
    # waiting for the destination's; the destination's current stream then
    # waits for the copy
    with torch.cuda.stream(src.stream), torch.cuda.stream(dst.stream):
        return x.to(dst.device, non_blocking=True)


def to_host(parts) -> list:
    """[(member, 1-D tensor on it)] -> the tensors as numpy arrays, in the
    same order, with one device-to-host copy per member, made on its stream
    after its work."""
    groups: dict = {}
    for i, (member, _t) in enumerate(parts):
        groups.setdefault(id(member), (member, []))[1].append(i)
    out: list = [None] * len(parts)
    for member, idxs in groups.values():
        with member.scope():
            flat = torch.cat([parts[i][1] for i in idxs]).cpu().numpy()
        off = 0
        for i in idxs:
            n = parts[i][1].numel()
            out[i] = flat[off : off + n]
            off += n
    return out

