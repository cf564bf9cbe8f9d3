"""Resource loading: files, includes, compressed data, scene archives
(counterpart of the JAX reference's ``scene/resources.py``).

gz / bz2 decompression, zip / tar(.gz / .bz2) scene archives unpacked in
memory, include-path search.
"""
from __future__ import annotations

import bz2
import gzip
import io
import os
import tarfile
import zipfile
from typing import Dict, List, Optional


class Resolver:
    """name -> file contents, searching include paths; caches; transparently
    decompresses .gz/.bz2/.z; serves members of a loaded archive."""

    def __init__(self, search_paths: Optional[List[str]] = None):
        self.search_paths = list(search_paths or ["."])
        self.cache: Dict[str, bytes] = {}
        self.archive: Dict[str, bytes] = {}

    def add_archive(self, path_or_bytes):
        """Load a zip/tar scene archive (scene.pbrt convention)."""
        data = path_or_bytes
        if isinstance(data, str):
            with open(data, "rb") as f:
                data = f.read()
        buf = io.BytesIO(data)
        if zipfile.is_zipfile(buf):
            z = zipfile.ZipFile(buf)
            for n in z.namelist():
                self.archive[os.path.basename(n)] = z.read(n)
                self.archive[n] = self.archive[os.path.basename(n)]
        else:
            buf.seek(0)
            try:
                t = tarfile.open(fileobj=buf)
                for m in t.getmembers():
                    if m.isfile():
                        d = t.extractfile(m).read()
                        self.archive[os.path.basename(m.name)] = d
                        self.archive[m.name] = d
            except tarfile.TarError as e:
                raise ValueError(f"unrecognized archive: {e}")

    def _decompress(self, name: str, data: bytes) -> bytes:
        if name.endswith(".gz") or data[:2] == b"\x1f\x8b":
            return gzip.decompress(data)
        if name.endswith(".bz2"):
            return bz2.decompress(data)
        return data

    def __call__(self, name: str, binary: bool = False):
        if name in self.cache:
            data = self.cache[name]
        elif name in self.archive:
            data = self._decompress(name, self.archive[name])
            self.cache[name] = data
        else:
            data = None
            for cand in [name] + [os.path.join(p, name)
                                  for p in self.search_paths]:
                for suffix in ("", ".gz"):
                    if os.path.exists(cand + suffix):
                        with open(cand + suffix, "rb") as f:
                            data = self._decompress(cand + suffix, f.read())
                        break
                if data is not None:
                    break
            if data is None:
                raise FileNotFoundError(name)
            self.cache[name] = data
        return data if binary else data.decode("utf-8", errors="replace")
