"""Durable artifact writes (``ncnet_tpu/resilience/durable.py``): temp +
fsync + atomic rename, digests, retention.

Every write goes

  1. to a temp file in the same directory (same filesystem, so the rename
     is atomic), fully written and ``fsync``'d;
  2. ``os.replace`` onto the final name: readers see the old bytes or the
     new bytes, never a mixture;
  3. a sidecar ``<path>.sha256`` (written the same way) records the
     payload digest, so corruption (bitrot, a torn pre-durability file, a
     truncating copy) is detected at load instead of surfacing as a
     confusing deserialization error;
  4. the parent directory is fsync'd so the rename itself survives a
     crash.

A kill before the rename leaves the previous artifact untouched; a kill
between the data rename and the sidecar rename leaves a digest mismatch,
so the new file reads as invalid. Retention keeps the last K step-tagged
copies (``<path>.step<N>``, hardlinked: no extra bytes), so a reader can
walk back past an invalid latest file: `candidates` yields paths
newest-first and `latest_valid` returns the first one that verifies.
The files are byte for byte the JAX package's, so either package reads
what the other wrote. The JAX module's fault-injection points are not
carried over. At most one writer per path is the caller's job.
"""

import hashlib
import os
import re

DIGEST_SUFFIX = ".sha256"

_STEP_RE = re.compile(r"\.step(\d+)$")


class IntegrityError(RuntimeError):
    """An artifact's bytes do not match its recorded digest."""


def digest_path(path):
    return path + DIGEST_SUFFIX


def _fsync_dir(dirname):
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return  # platforms/filesystems without directory fds: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path, blob):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def durable_write_bytes(path, blob):
    """Durably write ``blob`` to ``path`` with a sidecar digest; returns the
    absolute path."""
    path = os.path.abspath(path)
    dirname = os.path.dirname(path)
    os.makedirs(dirname, exist_ok=True)
    digest = hashlib.sha256(blob).hexdigest()
    _write_atomic(path, blob)
    _write_atomic(digest_path(path), digest.encode("ascii"))
    _fsync_dir(dirname)
    return path


def verify_digest(path):
    """``True``/``False`` when a sidecar digest exists and matches/differs;
    ``None`` when there is no sidecar (a pre-durability legacy file)."""
    dpath = digest_path(path)
    if not os.path.exists(dpath):
        return None
    with open(dpath, "rb") as f:
        want = f.read().strip().decode("ascii", errors="replace")
    with open(path, "rb") as f:
        got = hashlib.sha256(f.read()).hexdigest()
    return got == want


def read_verified_bytes(path):
    """Read ``path``, raising :class:`IntegrityError` on digest mismatch.

    Legacy files without a sidecar are returned as-is (the caller's parser
    is the only check available for them).
    """
    ok = verify_digest(path)
    if ok is False:
        raise IntegrityError(
            f"{path} does not match its recorded digest "
            f"({digest_path(path)}); treating as corrupt"
        )
    with open(path, "rb") as f:
        return f.read()


def step_path(path, step):
    return f"{path}.step{int(step):09d}"


def retain(path, step, keep=3):
    """Hardlink ``path`` (+ sidecar) to its step-tagged history name and
    prune history beyond the newest ``keep`` entries. ``keep <= 0``
    disables retention entirely.

    Hardlinks cost no bytes; the newest history entry shares its inode
    with the primary until the NEXT save replaces the primary (os.replace
    allocates a new inode, leaving history pointing at the old one). The
    durable writer never modifies files in place, so the only shared-fate
    hazard is bitrot of that one inode — which the walk-back then skips,
    at the cost of one extra fallback step."""
    if keep <= 0:
        return
    hist = step_path(path, step)
    for src in (path, digest_path(path)):
        dst = hist if src == path else digest_path(hist)
        if not os.path.exists(src):
            continue
        try:
            if os.path.exists(dst):
                os.remove(dst)
            os.link(src, dst)
        except OSError:
            import shutil

            shutil.copyfile(src, dst)
    steps = sorted(_history_steps(path), reverse=True)
    for old in steps[keep:]:
        for stale in (step_path(path, old), digest_path(step_path(path, old))):
            try:
                os.remove(stale)
            except FileNotFoundError:
                pass
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _history_steps(path):
    dirname = os.path.dirname(os.path.abspath(path))
    base = os.path.basename(path)
    steps = []
    try:
        names = os.listdir(dirname)
    except FileNotFoundError:
        return steps
    for name in names:
        if not name.startswith(base) or name.endswith(DIGEST_SUFFIX):
            continue
        m = _STEP_RE.search(name)
        if m and name == base + f".step{m.group(1)}":
            steps.append(int(m.group(1)))
    return steps


def candidates(path):
    """Resume candidates newest-first: the primary file, then step-tagged
    history in descending step order."""
    out = []
    if os.path.exists(path):
        out.append(path)
    for step in sorted(_history_steps(path), reverse=True):
        out.append(step_path(path, step))
    return out


def latest_valid(path, loader):
    """Walk `candidates` newest-first, returning ``(loader(p), p)`` for the
    first one that verifies AND parses; a torn/corrupt latest file costs
    one fallback, not the run. Raises ``FileNotFoundError`` when nothing
    loads."""
    errors = []
    for cand in candidates(path):
        try:
            if verify_digest(cand) is False:
                raise IntegrityError(f"{cand}: digest mismatch")
            return loader(cand), cand
        except Exception as e:  # a corrupt candidate must not end the walk
            errors.append(f"{cand}: {e!r}")
            print(f"[resilience] skipping invalid artifact {cand}: {e!r}",
                  flush=True)
    detail = "; ".join(errors) if errors else "no candidate files exist"
    raise FileNotFoundError(f"no valid artifact for {path} ({detail})")
