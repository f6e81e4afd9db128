# Sphinx configuration for hpfrec_jax (mirrors the reference's autodoc-driven
# docs, /root/reference/docs/conf.py).
import os
import sys

sys.path.insert(0, os.path.abspath(".."))

project = "hpfrec_jax"
author = "hpfrec_jax developers"
release = "0.1.0"

extensions = [
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
]

autodoc_member_order = "bysource"
html_theme = "sphinx_rtd_theme" if os.environ.get("USE_RTD_THEME") else "alabaster"
exclude_patterns = ["_build"]
