"""scene_build_s: the benchmark's span around the port's scene compile and
upload (parse or SceneBuilder.build, the BVH, to_device)."""


def read(rec):
    return rec.spans.get("scene_build")
