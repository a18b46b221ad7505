from intel_extension_for_transformers_tpu_torch.neural_chat.server.neuralchat_server import main

main()
