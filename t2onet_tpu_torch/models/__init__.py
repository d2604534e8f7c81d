"""The actor's networks: ResNet vision encoder, bi-LSTM request encoder,
attention decoder step, parameter heads and the greedy rollout; the
inpaint fillers; T2ONet+D's discriminator (gan.py), VGG19's perceptual
features (vgg.py) and pix2pixHD's generators (pix2pixhd.py)."""
