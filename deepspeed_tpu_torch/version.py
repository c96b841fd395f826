"""The port's version (counterpart of ``deepspeed_tpu/version.py``):
``git_hash`` and ``git_branch`` stay None unless a build fills them in."""

__version__ = "0.1.0"
git_hash = None
git_branch = None
