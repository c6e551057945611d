"""Scheduler core, executor and VDC manager of the port.

Kept minimal on purpose: importing a submodule must not pull in anything
beyond what it needs.
"""
