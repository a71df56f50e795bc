"""Native (C++) host components, bound via ctypes: the port's own copy of
``computervisionimagestich2_tpu.native`` (the BMP codec and its threaded
batch loader, ``codec.py``). Nothing here imports that package or loads
its library; the port builds its own from ``codec.cpp``."""
