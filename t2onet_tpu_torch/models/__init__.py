"""The actor's networks: ResNet vision encoder, bi-LSTM request encoder,
attention decoder step, parameter heads and the greedy rollout."""
