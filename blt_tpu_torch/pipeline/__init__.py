"""Engines, feeder and run loop of the torch port."""
