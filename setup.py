"""Packaging for hpfrec_jax.

The reference package (``/root/reference/setup.py:33-258``) subclasses
``build_ext`` to probe compiler flags (``-march=native``, LTO, eight
OpenMP flag spellings) and swap in a no-OpenMP fallback when the probe
fails.  Here the equivalent probing lives in
``hpfrec_jax/_native/build.py`` and runs lazily on first import, so the
package itself is pure Python and installs anywhere — including
machines with no C++ toolchain, where the host data layer falls back to
numpy/scipy transparently (``hpfrec_jax/utils/data.py``).

This setup.py additionally tries to warm the native build at
wheel-build time so a same-machine sdist/editable install doesn't pay
the ~1 s compile on first ``fit``.  Scope is deliberately narrow: a
wheel built on machine A and installed on machine B still compiles on
B's first use (the cache is per-machine), and failure here is non-fatal
by design (same philosophy as the reference's OpenMP fallback,
``setup.py:171-174``).
"""

import importlib.util
import os

from setuptools import setup
from setuptools.command.build_py import build_py


class build_py_warm_native(build_py):
    def run(self):
        super().run()
        try:
            # Load build.py directly — importing hpfrec_jax._native via the
            # package root would execute hpfrec_jax/__init__.py and pull in
            # jax, which is absent under PEP 517 build isolation.
            path = os.path.join(self.build_lib, "hpfrec_jax", "_native",
                                "build.py")
            spec = importlib.util.spec_from_file_location(
                "_hpfrec_jax_native_build", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.build_native(verbose=True)
        except Exception as e:  # no toolchain: numpy fallback paths take over
            print(f"note: native host kernels not prebuilt ({e!r}); "
                  "they will be built on first use or numpy fallbacks used")


setup(cmdclass={"build_py": build_py_warm_native})
