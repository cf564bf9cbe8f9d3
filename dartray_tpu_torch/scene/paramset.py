"""ParamSet: the typed named-parameter bag of a scene statement, and
TextureParams, the material-parameter lookup over (shape, material)
parameters with named textures (counterpart of the JAX reference's
``scene/paramset.py``).

Parameters live on the host (scene-compile time) as plain Python / numpy
values; device tensors appear only after scene compilation.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core import spectrum as spec

# Hook installed by the API while a scene is being built: .spd filename ->
# (lambdas, values) numpy arrays, or None on failure.
SPD_LOADER = None

_TYPES = {"float", "integer", "bool", "string", "point", "vector", "normal",
          "rgb", "color", "xyz", "blackbody", "spectrum", "texture"}


class ParamSet:
    def __init__(self):
        self.items: Dict[str, tuple] = {}   # name -> (type, values)
        self.used: set = set()

    def to_json(self):
        """{name: {"type": t, "values": [...]}} (param_set.dart toJson —
        the RenderOverrides wire format)."""
        return {name: {"type": t, "values": list(v)}
                for name, (t, v) in self.items.items()}

    @classmethod
    def from_json(cls, d):
        """Inverse of to_json; also accepts the shorthand {name: value}
        with type inferred from the python value."""
        ps = cls()
        for name, spec in (d or {}).items():
            if isinstance(spec, dict) and "type" in spec:
                ps.add(f"{spec['type']} {name}", spec.get("values", []))
                continue
            v = spec
            if isinstance(v, bool):
                ps.add(f"bool {name}", [v])
            elif isinstance(v, int):
                ps.add(f"integer {name}", [v])
            elif isinstance(v, float):
                ps.add(f"float {name}", [v])
            elif isinstance(v, str):
                ps.add(f"string {name}", [v])
            elif isinstance(v, (list, tuple)) and len(v) == 3:
                ps.add(f"rgb {name}", list(v))
            else:
                ps.add(f"float {name}", list(v))
        return ps

    def add(self, decl: str, values):
        """decl: 'float fov' style declaration (param_set.dart parsing)."""
        parts = decl.strip().split()
        if len(parts) == 1:
            ptype, name = "string", parts[0]
        else:
            ptype, name = parts[0], " ".join(parts[1:])
        if ptype not in _TYPES:
            raise ValueError(f"unknown param type {ptype!r} in {decl!r}")
        if not isinstance(values, (list, tuple, np.ndarray)):
            values = [values]
        self.items[name] = (ptype, list(values))

    # --- typed find_one accessors (param_set.dart findOne*) ---------------
    def _get(self, name, default, kinds):
        if name in self.items:
            t, v = self.items[name]
            if t in kinds:
                self.used.add(name)
                return v
        return None

    def find_one_float(self, name, default=0.0):
        v = self._get(name, default, ("float", "integer"))
        return float(v[0]) if v else float(default)

    def find_one_int(self, name, default=0):
        v = self._get(name, default, ("integer", "float"))
        return int(v[0]) if v else int(default)

    def find_one_bool(self, name, default=False):
        v = self._get(name, default, ("bool",))
        if v is None:
            return bool(default)
        x = v[0]
        return x in (True, "true", 1)

    def find_one_string(self, name, default=""):
        v = self._get(name, default, ("string", "texture"))
        return str(v[0]) if v else str(default)

    def find_one_point(self, name, default=(0, 0, 0)):
        v = self._get(name, default, ("point", "vector", "normal"))
        return np.asarray(v[:3], np.float64) if v else np.asarray(
            default, np.float64)

    def find_one_spectrum(self, name, default=(0.0, 0.0, 0.0)):
        """A 3-channel triple in the global spectrum mode: RGB primaries in
        "rgb" mode (rgb / color as given, xyz through the XYZ to RGB
        matrix, blackbody (temperature, scale) and spectrum data (inline
        (lambda, value) pairs or an .spd file) through the CIE observer),
        band averages in "sampled" mode (RGB converted with its XYZ, SPDs
        averaged over each band); a float is a grey in both."""
        sampled = spec.mode() == "sampled"
        bands = lambda c: (spec.rgb_to_bands(c).astype(np.float64)
                           if sampled else c)
        conv = spec.spd_to_bands if sampled else spec.spd_to_rgb
        if name in self.items:
            t, v = self.items[name]
            self.used.add(name)
            if t in ("rgb", "color"):
                return bands(np.asarray(v[:3], np.float64))
            if t == "xyz":
                return bands(np.asarray(spec.XYZ_TO_RGB, np.float64)
                             @ np.asarray(v[:3], np.float64))
            if t == "blackbody":
                temp = float(v[0])
                scale = float(v[1]) if len(v) > 1 else 1.0
                lam = np.arange(380.0, 781.0, 5.0)
                sp = spec.blackbody(lam, temp)
                sp = sp / max(sp.max(), 1e-30)
                return conv(lam, sp) * scale
            if t == "spectrum":
                if isinstance(v[0], str):
                    # an .spd file
                    if SPD_LOADER is not None:
                        lv = SPD_LOADER(str(v[0]))
                        if lv is not None:
                            return np.asarray(conv(lv[0], lv[1]), np.float64)
                    return np.asarray(default, np.float64)
                arr = np.asarray(v, np.float64).reshape(-1, 2)
                return np.asarray(conv(arr[:, 0], arr[:, 1]), np.float64)
            if t == "float":
                return np.full(3, float(v[0]))
        return np.asarray(default, np.float64)

    def find_texture(self, name) -> Optional[str]:
        if name in self.items and self.items[name][0] == "texture":
            self.used.add(name)
            return str(self.items[name][1][0])
        return None

    # --- array accessors ---------------------------------------------------
    def find_floats(self, name) -> Optional[np.ndarray]:
        v = self._get(name, None, ("float", "integer"))
        return np.asarray(v, np.float64) if v is not None else None

    def find_ints(self, name) -> Optional[np.ndarray]:
        v = self._get(name, None, ("integer", "float"))
        return np.asarray(v, np.int64) if v is not None else None

    def find_points(self, name) -> Optional[np.ndarray]:
        v = self._get(name, None, ("point", "vector", "normal"))
        return (np.asarray(v, np.float64).reshape(-1, 3)
                if v is not None else None)

    def find_uvs(self, name) -> Optional[np.ndarray]:
        v = self._get(name, None, ("float",))
        return (np.asarray(v, np.float64).reshape(-1, 2)
                if v is not None else None)

    def find_strings(self, name) -> Optional[List[str]]:
        v = self._get(name, None, ("string",))
        return [str(x) for x in v] if v is not None else None

    def report_unused(self, where="", log=None):
        """(param_set.dart reportUnused) — flags config typos."""
        unused = [k for k in self.items if k not in self.used]
        if unused and log:
            log(f"unused parameters in {where}: {unused}")
        return unused


class TextureParams:
    """Material-parameter resolution over (geom_params, material_params)
    with named-texture lookup (lib/core/texture_params.dart)."""

    def __init__(self, geom: ParamSet, mat: ParamSet,
                 float_textures: Dict[str, Any],
                 spectrum_textures: Dict[str, Any]):
        self.geom = geom
        self.mat = mat
        self.float_textures = float_textures
        self.spectrum_textures = spectrum_textures

    def get_spectrum(self, name, default):
        tex = self.geom.find_texture(name) or self.mat.find_texture(name)
        if tex is not None:
            return ("texture", tex)
        if name in self.geom.items:
            return ("const", self.geom.find_one_spectrum(name, default))
        return ("const", self.mat.find_one_spectrum(name, default))

    def get_float(self, name, default):
        tex = self.geom.find_texture(name) or self.mat.find_texture(name)
        if tex is not None:
            return ("texture", tex)
        if name in self.geom.items:
            return ("const", self.geom.find_one_float(name, default))
        return ("const", self.mat.find_one_float(name, default))

    def find_one_float(self, name, default=0.0):
        if name in self.geom.items:
            return self.geom.find_one_float(name, default)
        return self.mat.find_one_float(name, default)

    def find_one_string(self, name, default=""):
        if name in self.geom.items:
            return self.geom.find_one_string(name, default)
        return self.mat.find_one_string(name, default)

    def find_one_bool(self, name, default=False):
        if name in self.geom.items:
            return self.geom.find_one_bool(name, default)
        return self.mat.find_one_bool(name, default)
