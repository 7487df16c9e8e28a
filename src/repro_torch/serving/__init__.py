"""Serving layer: engine, sampler, front-end, requests, faults, network."""
