// Minimal TCP transport for the control plane: framed messages over a
// star topology (coordinator = rank 0 listens; workers hold one
// persistent connection each).
//
// Reference analog: the Gloo controller's TCP stores + HTTP rendezvous
// (horovod/common/gloo/gloo_context.cc:67-230); the
// reference reuses gloo's transport, we use raw sockets (8-byte length
// prefix per frame).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace hvd {

// RAII socket wrapper; all methods return false on error.
class Socket {
 public:
  Socket() = default;
  explicit Socket(int fd) : fd_(fd) {}
  ~Socket();
  Socket(const Socket&) = delete;
  Socket& operator=(const Socket&) = delete;
  Socket(Socket&& o) noexcept : fd_(o.fd_) { o.fd_ = -1; }
  Socket& operator=(Socket&& o) noexcept;

  bool Connect(const std::string& host, int port, double timeout_s);
  bool SendFrame(const std::vector<uint8_t>& payload);
  bool RecvFrame(std::vector<uint8_t>* payload);
  void Close();
  bool valid() const { return fd_ >= 0; }
  int fd() const { return fd_; }

 private:
  bool SendAll(const void* data, size_t len);
  bool RecvAll(void* data, size_t len);
  int fd_ = -1;
};

class Listener {
 public:
  // Binds 0.0.0.0:port (port 0 = ephemeral). bound_port() after Listen.
  bool Listen(int port);
  Socket Accept(double timeout_s);
  int bound_port() const { return port_; }
  void Close();
  ~Listener();

 private:
  int fd_ = -1;
  int port_ = 0;
};

}  // namespace hvd
