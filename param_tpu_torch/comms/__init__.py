"""The collective sweep benchmark: tensor prep and validation
(:mod:`.harness`) and the nccl-tests-style sweep (:mod:`.coll_bench`)."""
