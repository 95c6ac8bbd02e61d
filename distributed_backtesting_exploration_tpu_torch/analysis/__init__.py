"""Analysis of the port: the runtime lockdep shim (:mod:`.lockdep`) alone.

The dispatcher's ``_lockdep_report`` stats source and its ``main`` read
it. The reference's static analysis (``dbxlint``, ``dbxcert``) has no port
yet; this package imports nothing else.
"""
