"""The plain reference of the benchmark: the admixture and mixture models'
log likelihood and EM step in plain PyTorch, written from the models'
equations and independent of the program under test (it imports nothing
of it), computed in float64 in blocks of rows so that it fits beside the
panel; and the judge that turns a fit's answer into the numbers that
decide ``correct``."""
