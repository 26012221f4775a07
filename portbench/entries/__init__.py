"""Entry points of the port, one module each: ``prepare(device)`` loads
the kernel library, ``build(x, config, seed, device)`` returns the system
under test, whose ``search(q)`` returns (ids, scores, pages) for one batch
with ids and scores on the host, ``meta`` the index's shapes and
``close()`` frees it."""
