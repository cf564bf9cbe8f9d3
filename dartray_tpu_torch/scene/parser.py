"""PBRT statement parser: tokens -> PbrtAPI calls (counterpart of the JAX
reference's ``scene/parser.py``).

Statement dispatch, typed parameter lists into a ParamSet, ``Include``
through the resolver (``resources.Resolver``, which also serves zip / tar
scene archives).
"""
from __future__ import annotations

from .. import device as device_mod
from .. import stats
from . import lexer as lx
from . import paramset as ps
from .api import PbrtAPI, RenderJob


def _parse_params(lex: lx.Lexer) -> ps.ParamSet:
    """Parse '"type name" [values...]' pairs until a non-string token."""
    params = ps.ParamSet()
    while True:
        t = lex.peek()
        if t.kind != lx.STRING:
            return params
        decl = lex.next().value
        t = lex.peek()
        values = []
        if t.kind == lx.LBRACK:
            lex.next()
            while True:
                t = lex.next()
                if t.kind == lx.RBRACK:
                    break
                if t.kind == lx.EOF:
                    raise SyntaxError("unterminated [ in parameter list")
                values.append(t.value)
        else:
            values.append(lex.next().value)
        params.add(decl, values)


def _floats(lex: lx.Lexer, n: int):
    out = []
    while len(out) < n:
        t = lex.next()
        if t.kind == lx.LBRACK or t.kind == lx.RBRACK:
            continue
        if t.kind != lx.NUMBER:
            raise SyntaxError(f"expected number, got {t.value!r} "
                              f"(line {t.line})")
        out.append(float(t.value))
    return out


def _string(lex: lx.Lexer) -> str:
    t = lex.next()
    if t.kind != lx.STRING:
        raise SyntaxError(f"expected string, got {t.value!r} (line {t.line})")
    return t.value


@stats.spanned("parse")
def parse(text: str, api: PbrtAPI = None, resolver=None,
          log=lambda *a: None, device=device_mod.DEFAULT) -> RenderJob:
    """Parse a complete scene; returns the RenderJob from WorldEnd. `device`
    is where the job's camera generates rays (``PbrtAPI``)."""
    api = api or PbrtAPI(resolver=resolver, log=log, device=device)
    lex = lx.Lexer(text, resolver=lambda name: resolver(name)
                   if resolver else None)
    job = None
    while True:
        t = lex.next()
        if t.kind == lx.EOF:
            break
        if t.kind != lx.IDENT:
            raise SyntaxError(f"unexpected token {t.value!r} (line {t.line})")
        cmd = t.value
        if cmd == "Include":
            lex.add_include(_string(lex))
        elif cmd == "Identity":
            api.identity()
        elif cmd == "Translate":
            api.translate(*_floats(lex, 3))
        elif cmd == "Scale":
            api.scale(*_floats(lex, 3))
        elif cmd == "Rotate":
            api.rotate(*_floats(lex, 4))
        elif cmd == "LookAt":
            api.look_at(*_floats(lex, 9))
        elif cmd == "Transform":
            api.set_transform(_floats(lex, 16))
        elif cmd == "ConcatTransform":
            api.concat_transform(_floats(lex, 16))
        elif cmd == "CoordinateSystem":
            api.coordinate_system(_string(lex))
        elif cmd == "CoordSysTransform":
            api.coord_sys_transform(_string(lex))
        elif cmd == "ActiveTransform":
            which = lex.next().value
            {"All": api.active_transform_all,
             "StartTime": api.active_transform_start,
             "EndTime": api.active_transform_end}.get(
                 which, api.active_transform_all)()
        elif cmd == "TransformTimes":
            api.set_transform_times(*_floats(lex, 2))
        elif cmd == "Camera":
            api.camera(_string(lex), _parse_params(lex))
        elif cmd == "Film":
            api.film(_string(lex), _parse_params(lex))
        elif cmd == "Sampler":
            api.sampler(_string(lex), _parse_params(lex))
        elif cmd == "PixelSampler":
            api.pixel_sampler(_string(lex), _parse_params(lex))
        elif cmd == "PixelFilter":
            api.pixel_filter(_string(lex), _parse_params(lex))
        elif cmd == "Accelerator":
            api.accelerator(_string(lex), _parse_params(lex))
        elif cmd == "Renderer":
            api.renderer(_string(lex), _parse_params(lex))
        elif cmd == "SurfaceIntegrator":
            api.surface_integrator(_string(lex), _parse_params(lex))
        elif cmd == "VolumeIntegrator":
            api.volume_integrator(_string(lex), _parse_params(lex))
        elif cmd == "WorldBegin":
            api.world_begin()
        elif cmd == "WorldEnd":
            job = api.world_end()
        elif cmd == "AttributeBegin":
            api.attribute_begin()
        elif cmd == "AttributeEnd":
            api.attribute_end()
        elif cmd == "TransformBegin":
            api.transform_begin()
        elif cmd == "TransformEnd":
            api.transform_end()
        elif cmd == "ReverseOrientation":
            api.reverse_orientation()
        elif cmd == "Texture":
            name = _string(lex)
            tex_class = _string(lex)
            tex_type = _string(lex)
            api.texture(name, tex_class, tex_type, _parse_params(lex))
        elif cmd == "Material":
            api.material(_string(lex), _parse_params(lex))
        elif cmd == "MakeNamedMaterial":
            api.make_named_material(_string(lex), _parse_params(lex))
        elif cmd == "NamedMaterial":
            api.named_material(_string(lex))
        elif cmd == "LightSource":
            api.light_source(_string(lex), _parse_params(lex))
        elif cmd == "AreaLightSource":
            api.area_light_source(_string(lex), _parse_params(lex))
        elif cmd == "Shape":
            api.shape(_string(lex), _parse_params(lex))
        elif cmd == "ObjectBegin":
            api.object_begin(_string(lex))
        elif cmd == "ObjectEnd":
            api.object_end()
        elif cmd == "ObjectInstance":
            api.object_instance(_string(lex))
        elif cmd == "Volume":
            api.volume(_string(lex), _parse_params(lex))
        else:
            log(f"warning: unknown directive {cmd!r} (line {t.line})")
            # swallow a possible name + params
            if lex.peek().kind == lx.STRING:
                _string(lex)
                _parse_params(lex)
    if job is None:
        raise SyntaxError("scene has no WorldEnd")
    return job
