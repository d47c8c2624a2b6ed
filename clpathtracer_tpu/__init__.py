"""clpathtracer_tpu — a differentiable kd-tree/grid path tracer in JAX.

A from-scratch JAX/XLA re-imagining of the capabilities of
taylor-santos/CLPathTracer (an interactive OpenCL kd-tree path tracer):

* OBJ mesh ingest (reference: src/model.c, include/tinyobj_loader_c.h)
* SAH kd-tree construction with ropes (reference: src/kd_tree.c)
* stackless ray traversal + Moller-Trumbore intersection (reference: src/kernel.cl)
* camera model with inverse view-projection unprojection (reference: src/camera.c)

re-designed for an accelerator (an NVIDIA GPU) through XLA:

* rays are batched SoA arrays; traversal is a lockstep masked wavefront
  (`lax.while_loop`) instead of divergent per-ray loops
* the scene and acceleration structure are flat SoA device arrays (pytrees)
* rendering is a pure function: scene in, image out — jit/pjit boundaries
  replace OpenCL command queues
* differentiable: pixel gradients w.r.t. camera pose, vertex positions and
  materials via detached-topology custom VJPs
* distributed: pixel tiles sharded over `jax.sharding.Mesh` axes with XLA
  collectives, not hand-written transport
"""

__version__ = "0.2.0"

from clpathtracer_tpu.core.camera import Camera, cam_matrix, generate_rays


def __getattr__(name):
    """Lazy high-level API (keeps `import clpathtracer_tpu` light)."""
    if name in ("RenderOptions", "render_image"):
        from clpathtracer_tpu.render import integrator
        return getattr(integrator, name)
    if name in ("load_model", "load_models", "merge_scenes"):
        from clpathtracer_tpu.scene import cache
        return getattr(cache, name)
    if name == "Scene":
        from clpathtracer_tpu.scene.scene import Scene
        return Scene
    if name == "build_kd_tree":
        from clpathtracer_tpu.accel.sah import build_kd_tree
        return build_kd_tree
    if name == "write_png":
        from clpathtracer_tpu.utils.png import write_png
        return write_png
    raise AttributeError(name)


__all__ = [
    "Camera", "cam_matrix", "generate_rays", "RenderOptions",
    "render_image", "load_model", "load_models", "merge_scenes", "Scene",
    "build_kd_tree", "write_png", "__version__",
]
