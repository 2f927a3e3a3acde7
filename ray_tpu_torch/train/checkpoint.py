"""Checkpoints: directory-backed, tensor-tree aware, URI-portable.

Port of ``ray_tpu/train/checkpoint.py`` (reference: python/ray/air/
checkpoint.py, the dict/dir/URI morphable Checkpoint;
air/_internal/remote_storage.py and Train's checkpoint manager). A
Checkpoint is a directory. A tree of tensors (nested dicts, lists,
tuples, named tuples; ``torch.utils._pytree``) is saved with
``torch.distributed.checkpoint`` ("DCP") where the JAX package uses orbax:
every tensor leaf (a DTensor included: in a multi-process group each rank
writes its own shards, so sharded state saves without a gather) goes into
one DCP state dict ``{str(i): tensor}``, and the tree spec with the
non-tensor leaves is pickled to ``aux.pkl``. ``to_uri``/``from_uri`` morph
a checkpoint to and from remote storage (file:// memory:// gs:// s3://).

The commit rule: orbax writes into a temporary directory and renames it,
so the arrays directory exists only once a save is whole. DCP writes in
place, so ``from_state`` saves into ``arrays.tmp`` and renames it to
``arrays`` only after the save (or, with ``async_save``, its future) has
finished; ``_complete`` requires ``arrays``, so a save killed half-way is
never restored from. Every rank renames its own host's ``arrays.tmp``: on
hosts without a shared filesystem each holds only its own shards there,
and a checkpoint mirrored to a URI is the merge of every rank's
``arrays``.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train import storage

_ARRAYS_SUBDIR = "arrays"
#: DCP writes here; renamed to _ARRAYS_SUBDIR once the save is whole
_ARRAYS_TMP = "arrays.tmp"
_AUX_FILE = "aux.pkl"
#: written last to a mirrored checkpoint URI — a remote copy without it is
#: a partial upload and is never restored from
_REMOTE_MARKER = ".ray_tpu_complete"


def _is_tensor(x: Any) -> bool:
    """A torch.Tensor (DTensor included), without importing torch for
    trees that hold none."""
    import sys

    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _group_world() -> int:
    """The size of the default process group (1 when there is none)."""
    import torch.distributed as dist

    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


def _group_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if (dist.is_available()
                               and dist.is_initialized()) else 0


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


@contextlib.contextmanager
def _quiet():
    """Silence what torch says about nothing wrong: DCP's note that a
    save without a process group is a single-process one, and pytree's
    deprecation note when a tree spec is unpickled."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*torch.distributed is "
                                "disabled.*", category=UserWarning)
        warnings.filterwarnings("ignore", message=".*LeafSpec.*",
                                category=FutureWarning)
        yield


def _read_aux(path: str) -> dict:
    with _quiet(), open(os.path.join(path, _AUX_FILE), "rb") as f:
        return pickle.load(f)


class _Pending:
    """DCP async saves of this process not yet committed: (future, tmp
    dir, final dir). ``wait()`` joins them in order and renames each into
    place; a save or load joins them first, as the reference waits on its
    orbax checkpointer."""

    def __init__(self):
        self.lock = threading.Lock()
        self.saves: List[tuple] = []

    def add(self, fut, tmp: str, final: str) -> None:
        with self.lock:
            self.saves.append((fut, tmp, final))

    def join(self) -> None:
        with self.lock:
            saves, self.saves = self.saves, []
        for fut, tmp, final in saves:
            fut.result()
            _commit(tmp, final)


_pending = _Pending()


def _commit(tmp: str, final: str) -> None:
    """Rename this host's finished save into place. A DCP save returns on
    every rank only once every rank's writes are done, so any rank may
    commit; on a shared filesystem the first rename wins and the other
    ranks find ``tmp`` gone."""
    try:
        os.rename(tmp, final)
    except FileNotFoundError:
        pass


class Checkpoint:
    def __init__(self, path: str, uri: Optional[str] = None):
        self.path = os.path.abspath(path)
        #: remote home of this checkpoint, when it has one — carried through
        #: pickling so a worker on another node can re-download (ref:
        #: air Checkpoint URI morphs)
        self.uri = uri

    # --- constructors -------------------------------------------------------

    @classmethod
    def from_dict(cls, data: Dict[str, Any],
                  base_dir: Optional[str] = None) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="ckpt_", dir=base_dir)
        with open(os.path.join(d, "payload.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        """ref: air/checkpoint.py Checkpoint.from_directory."""
        return cls(path)

    @classmethod
    def from_state(cls, state: Any, path: str,
                   async_save: bool = False) -> "Checkpoint":
        """Save a tree of tensors (params, an optimizer's ``state_dict()``,
        step counters, ...) with DCP.

        Tensor leaves (detached; CUDA tensors are copied to the host by
        DCP's writer) go into one DCP state dict; non-tensor leaves
        (numbers, strings, numpy arrays, callables) and the tree spec are
        pickled to aux.pkl and re-attached at load. In a process group of
        more than one rank the save is collective: every rank must call it
        with the same tree on the same path; DTensor leaves are written
        shard by shard by their owners, a plain tensor once (DCP keeps one
        copy of what every rank holds), and aux.pkl by rank 0. With
        async_save the writes run in the background and are committed by
        ``wait()`` (or the next save or load).
        """
        from torch.utils import _pytree as pytree

        _pending.join()          # serialize with a previous async save
        os.makedirs(path, exist_ok=True)
        multiproc = _group_world() > 1
        primary = _group_rank() == 0
        leaves, spec = pytree.tree_flatten(state)
        tensors = {str(i): leaf.detach() for i, leaf in enumerate(leaves)
                   if _is_tensor(leaf)}
        others = {i: leaf for i, leaf in enumerate(leaves)
                  if not _is_tensor(leaf)}
        if primary:
            with open(os.path.join(path, _AUX_FILE), "wb") as f:
                pickle.dump({"treedef": spec, "others": others,
                             "n": len(leaves), "ts": time.time(),
                             "procs": _group_world()}, f)
        if not tensors:
            return cls(path)
        import torch.distributed.checkpoint as dcp

        tmp = os.path.join(path, _ARRAYS_TMP)
        final = os.path.join(path, _ARRAYS_SUBDIR)
        # each rank clears its own host's copy of an earlier save here
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(final, ignore_errors=True)
        if multiproc:
            _barrier()           # nobody writes before the old copies go
        writer = dcp.FileSystemWriter(tmp)
        if async_save:
            with _quiet():
                resp = dcp.async_save(tensors, storage_writer=writer,
                                      no_dist=not multiproc)
            # newer releases answer with (staging, upload) futures
            fut = getattr(resp, "upload_completion", resp)
            _pending.add(fut, tmp, final)
            return cls(path)
        with _quiet():
            dcp.save(tensors, storage_writer=writer, no_dist=not multiproc)
        _commit(tmp, final)
        if multiproc:
            _barrier()           # every rank returns after every commit
        return cls(path)

    @classmethod
    def from_uri(cls, uri: str, local_dir: Optional[str] = None) -> "Checkpoint":
        """Download a checkpoint from remote storage
        (ref: air/checkpoint.py Checkpoint.from_uri)."""
        d = local_dir or tempfile.mkdtemp(prefix="ckpt_dl_")
        storage.download_from_uri(uri, d)
        return cls(d, uri=uri)

    # --- accessors ----------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        self._ensure_local()
        p = os.path.join(self.path, "payload.pkl")
        with open(p, "rb") as f:
            return pickle.load(f)

    def load_state(self, abstract_state: Any = None) -> Any:
        """Load the tree saved by from_state.

        abstract_state: optional tree of the same structure whose tensor
        leaves say where each restored tensor goes: a tensor (or DTensor)
        leaf is the target of that position, and the loaded tensor is
        allocated like it (``torch.empty_like``: its device, dtype and,
        for a DTensor, its mesh and placements, so each rank reads only
        its shards). In a process group of more than one rank this is
        collective. Without a target, every tensor comes back whole as a
        CPU tensor allocated from the DCP metadata, read by this process
        alone (the driver inspecting a result, a checkpoint saved by more
        ranks than read it).
        """
        self._ensure_local()
        from torch.utils import _pytree as pytree

        _pending.join()
        aux = _read_aux(self.path)
        arrays_dir = os.path.join(self.path, _ARRAYS_SUBDIR)
        tensor_idx = [i for i in range(aux["n"]) if i not in aux["others"]]
        restored: Dict[str, Any] = {}
        if tensor_idx:
            import torch
            import torch.distributed.checkpoint as dcp

            reader = dcp.FileSystemReader(arrays_dir)
            targets = None
            if abstract_state is not None:
                tleaves = pytree.tree_leaves(abstract_state)
                if len(tleaves) != aux["n"]:
                    raise ValueError(
                        f"abstract_state has {len(tleaves)} leaves; "
                        f"checkpoint has {aux['n']}")
                if all(_is_tensor(tleaves[i]) for i in tensor_idx):
                    targets = tleaves
            if targets is not None:
                restored = {str(i): torch.empty_like(targets[i])
                            for i in tensor_idx}
                with _quiet():
                    dcp.load(restored, storage_reader=reader,
                             no_dist=_group_world() == 1)
            else:
                meta = reader.read_metadata().state_dict_metadata
                restored = {k: torch.empty(tuple(m.size),
                                           dtype=m.properties.dtype)
                            for k, m in meta.items()}
                with _quiet():
                    dcp.load(restored, storage_reader=reader, no_dist=True)
        leaves = [aux["others"][i] if i in aux["others"] else restored[str(i)]
                  for i in range(aux["n"])]
        return pytree.tree_unflatten(leaves, aux["treedef"])

    def to_directory(self) -> str:
        """ref: air/checkpoint.py Checkpoint.to_directory — a Checkpoint
        IS a directory here, so this is the identity accessor (plus a
        lazy download when the data still lives at the URI)."""
        self._ensure_local()
        return self.path

    def to_uri(self, uri: str, write_marker: bool = True) -> str:
        """Upload this checkpoint to remote storage
        (ref: air/checkpoint.py Checkpoint.to_uri). The completion marker
        is written last so a partial upload is never restored from;
        multi-rank mirrors pass write_marker=False and let rank 0 write it
        after a cross-rank barrier."""
        self.wait()
        storage.upload_to_uri(self.path, uri)
        if write_marker:
            storage.touch_at_uri(storage.join_uri(uri, _REMOTE_MARKER))
        self.uri = uri
        return uri

    def wait(self) -> None:
        """Join and commit this process's in-flight async DCP saves."""
        _pending.join()

    def exists(self) -> bool:
        return os.path.isdir(self.path) and bool(os.listdir(self.path))

    def saved_process_count(self) -> Optional[int]:
        """The process group's size at save time (None: unreadable).
        An elastic resume compares this with the NEW world size — DCP
        reshards a checkpoint saved by another number of ranks at load,
        which is worth a remediation-event note for the operator
        timeline."""
        self._ensure_local()
        return _saved_procs(self.path)

    def _ensure_local(self) -> None:
        """Download from the URI when the local copy is absent or partial
        (a checkpoint pickled to a worker on another node, or a staging
        dir truncated by a crash). Lazy: runs at first read, so handles
        that merely pass a checkpoint around never transfer data. An
        flock serializes same-host readers racing to populate the same
        staging dir."""
        if _complete(self.path) or not self.uri:
            return
        import fcntl

        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path + ".lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if _complete(self.path):  # loser of the race: winner populated
                return
            if not CheckpointManager._marked(self.uri):
                raise RuntimeError(
                    f"remote checkpoint {self.uri} has no completion "
                    f"marker (upload still running or died); refusing to "
                    f"restore a partial copy")
            storage.download_from_uri(self.uri, self.path)
            if not _complete(self.path):
                raise RuntimeError(
                    f"downloaded checkpoint from {self.uri} is incomplete")

    def __reduce__(self):
        return (Checkpoint, (self.path, self.uri))

    def __repr__(self):
        return f"Checkpoint({self.path})"


def _ckpt_index(name: str) -> Optional[int]:
    """Index of a checkpoint_NNNNNN dir name; None for anything else
    (crashed download temps, markers, user files)."""
    if not name.startswith("checkpoint_"):
        return None
    try:
        return int(name.split("_")[-1])
    except ValueError:
        return None


def _saved_procs(path: str) -> Optional[int]:
    """process count recorded at save time; None when unreadable."""
    try:
        return _read_aux(path).get("procs", 1)
    except Exception:
        # payload checkpoints are single-process by nature
        if os.path.exists(os.path.join(path, "payload.pkl")):
            return 1
        return None


def _complete(path: str) -> bool:
    """True when `path` holds a complete checkpoint: a payload.pkl, or
    aux.pkl plus (when tensor leaves exist) a committed DCP dir —
    ``from_state`` renames ``arrays.tmp`` to ``arrays`` only after the
    save finished, so a crash mid-write never passes this check."""
    if not os.path.isdir(path):
        return False
    if os.path.exists(os.path.join(path, "payload.pkl")):
        return True
    if not os.path.exists(os.path.join(path, _AUX_FILE)):
        return False
    try:
        aux = _read_aux(path)
    except Exception:
        return False
    has_arrays = aux["n"] > len(aux["others"])
    return (not has_arrays
            or os.path.isdir(os.path.join(path, _ARRAYS_SUBDIR)))


class CheckpointManager:
    """Keeps the last N checkpoints in a run directory (ref:
    CheckpointConfig.num_to_keep + air checkpoint manager).

    run_dir may be a local path or a storage URI (file:// memory:// gs://
    s3://). With a URI, checkpoints are written to a deterministic local
    staging dir and mirrored to the URI on register(); latest() prefers
    local staging but falls back to downloading from the URI — so a
    restarted (or migrated) job resumes from cloud storage with no local
    state. ref: air _internal/remote_storage.py + SURVEY §5.4.
    """

    def __init__(self, run_dir: str, num_to_keep: Optional[int] = None):
        self.uri: Optional[str] = None
        if storage.is_uri(run_dir):
            self.uri = run_dir.rstrip("/")
            run_dir = storage.local_staging_dir(self.uri)
        self.run_dir = run_dir
        self.num_to_keep = num_to_keep
        os.makedirs(run_dir, exist_ok=True)
        self._index = 0
        self._kept: list[str] = []
        self._mirror_q: Optional[Any] = None  # lazy upload-worker queue
        #: background mirror failures (persistence problems surfaced to
        #: callers that check; each is also logged when it happens)
        self.mirror_errors: List[str] = []
        self._load_existing()

    def _load_existing(self):
        names = {d for d in os.listdir(self.run_dir)
                 if _ckpt_index(d) is not None}
        if self.uri:
            names |= {d for d in storage.list_at_uri(self.uri)
                      if _ckpt_index(d) is not None}
        existing = sorted(names)
        self._kept = [os.path.join(self.run_dir, d) for d in existing]
        if existing:
            self._index = _ckpt_index(existing[-1]) + 1

    def new_dir(self, index: Optional[int] = None) -> str:
        """Next checkpoint dir. Pass `index` to pin a rank-agreed slot (a
        multi-host gang broadcasts rank 0's index and every rank MUST use
        exactly that slot — the collective DCP save writes every rank's
        shards into that one directory, so any rank diverging splits the
        checkpoint and hangs the gang at its barrier)."""
        if index is not None:
            self._index = index
        path = os.path.join(self.run_dir, f"checkpoint_{self._index:06d}")
        self._index += 1
        return path

    def register(self, path: str, primary: bool = True,
                 sync: bool = True):
        """Track a saved checkpoint; mirror it to the URI when set.

        In a multi-process gang every rank registers (each uploads the DCP
        shard files its process wrote — the remote dir is the merge), but
        only the primary writes the completion marker and performs remote
        eviction. The caller must barrier between non-primary and primary
        registration so the marker lands after all shards
        (session.report does). With sync=False (single-process mode) the
        upload+marker+remote-evict run on a background thread in FIFO
        order so the train loop isn't stalled for the transfer; call
        flush() to join (a checkpoint whose upload hasn't finished is
        protected by the marker gate in latest())."""
        evict: List[str] = []
        self._kept.append(path)
        if self.num_to_keep is not None:
            while len(self._kept) > self.num_to_keep:
                evict.append(self._kept.pop(0))

        def evict_local():
            for old in evict:
                shutil.rmtree(old, ignore_errors=True)

        def mirror():
            # eviction rides the mirror job so an evicted checkpoint's own
            # queued upload (FIFO-earlier) always finishes first
            Checkpoint(path).to_uri(
                storage.join_uri(self.uri, os.path.basename(path)),
                write_marker=primary)
            if primary:
                for old in evict:
                    storage.delete_at_uri(
                        storage.join_uri(self.uri, os.path.basename(old)))
            evict_local()

        if self.uri:
            if sync:
                mirror()
            else:
                self._enqueue_mirror(mirror)
        else:
            evict_local()

    def _enqueue_mirror(self, job) -> None:
        if self._mirror_q is None:
            import queue

            self._mirror_q = queue.Queue()

            def worker():
                while True:
                    j = self._mirror_q.get()
                    try:
                        if j is not None:
                            j()
                    except Exception as e:
                        # marker gate keeps the partial upload unrestorable,
                        # but the operator must hear persistence is failing
                        import logging

                        logging.getLogger(__name__).exception(
                            "background checkpoint mirror failed: %s", e)
                        self.mirror_errors.append(str(e))
                    finally:
                        self._mirror_q.task_done()

            import threading

            threading.Thread(target=worker, daemon=True,
                             name="ckpt-mirror").start()
        self._mirror_q.put(job)

    def flush(self) -> None:
        """Join all queued background mirrors."""
        if self._mirror_q is not None:
            self._mirror_q.join()

    def latest(self) -> Optional[Checkpoint]:
        for path in reversed(self._kept):
            remote = (storage.join_uri(self.uri, os.path.basename(path))
                      if self.uri else None)
            if _complete(path):
                # a marker-less mirror (crash mid-upload) must never be
                # downloaded by another node — heal it from the local
                # copy, but ONLY if that copy holds every shard (i.e. a
                # single-process save; one host of a collective save
                # can't certify the other hosts' shards)
                if remote and not self._marked(remote):
                    if _saved_procs(path) == 1:
                        try:
                            Checkpoint(path).to_uri(remote)
                        except Exception:
                            remote = None
                    else:
                        remote = None
                return Checkpoint(path, uri=remote)
            # Local copy absent or partial (crash mid-save/mid-download):
            # hand back a lazy remote-backed checkpoint — but only when
            # the upload finished (marker present). No data moves here;
            # load_state downloads on first read. Transient storage errors
            # skip to the next-older candidate instead of aborting the
            # caller's recovery loop.
            if remote and self._marked(remote):
                return Checkpoint(path, uri=remote)
        return None

    @staticmethod
    def _marked(remote: str) -> bool:
        try:
            return storage.exists_at_uri(
                storage.join_uri(remote, _REMOTE_MARKER))
        except Exception:
            # transient storage error: treat as unusable, caller moves on
            # to an older candidate instead of aborting its recovery loop
            return False
