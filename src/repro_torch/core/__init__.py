"""The paper's contribution: DS-Softmax serving (gating, dispatch, retrieval)."""
