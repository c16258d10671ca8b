"""Float64 oracles of the reference's fragment shader (counterpart of
``schwarzschild_tpu.oracle``): ``reference``, the pure-Python
transcription (draws the debug test ray), and ``native``, the binding of
its C++ twin ``native/oracle.cpp`` with the full-size parity method."""

from .reference import OracleScene, render_image, render_pixel, trace_ray

__all__ = ["OracleScene", "render_image", "render_pixel", "trace_ray"]
