# OPTIONAL layer. Add <name>.py (or .cu) + ops.py + ref.py ONLY
# for compute hot-spots the paper itself optimizes with a custom
# kernel. Leave this package empty if the paper has none.
