"""The big-LM stack's layers: norms/RoPE/projections (``basic``), GQA
attention, the Mamba2 SSD mixer and the RWKV6 time/channel mixers."""
