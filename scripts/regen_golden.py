#!/usr/bin/env python
"""Regenerate transcript determinism goldens (on the CPU)."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ["JAX_PLATFORMS"] = "cpu"
import runpy
runpy.run_path(os.path.join(os.path.dirname(__file__), "..", "tests", "test_golden.py"),
               run_name="__main__")
