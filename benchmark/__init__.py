"""The benchmark of the PyTorch and CUDA port (``first_raytracer_tpu_torch``).

``benchmark/run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything
that decides a number lives here, where the program's own changes cannot
move it: the scene construction, the traffic, the window's arithmetic, the
trace reduction, the roofline arithmetic and the plain reference that
decides ``correct``.  From the program the benchmark takes only the entry
points it times and the kernel names the profiler reports.
"""
